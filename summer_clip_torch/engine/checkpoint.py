"""Checkpointing with the trainable-parameters-only split.

Counterpart of ``summer_clip_tpu/engine/checkpoint.py``: a checkpoint directory
holds ``model.ckpt`` (the parameter tree, or the subset a path predicate
keeps, so frozen weights never reach the disk), ``optimizer.ckpt`` and a
``meta.yaml`` with what rebuilds the model (``model_cfg``, and the seed that
initialised it, where the JAX package records its ``init_key``).

Trees are nested dicts of tensors with the JAX package's paths; an optimizer's
state is its ``state_dict()`` (``engine/optim``), restored into the optimizer
built for the run by ``load_checkpoint(..., opt_target=...)``. The port writes
its tensors with ``torch.save``.

**The JAX package's checkpoints.** There a tree is written by
``flax.serialization.to_bytes``: msgpack, with numpy arrays as extension
types. :func:`msgpack_restore` reads that subset of msgpack in pure Python
(this package imports neither ``msgpack`` nor ``flax``): every msgpack type,
flax's ndarray / native complex / numpy scalar extensions (codes 1-3; an
ndarray is the msgpack of ``(shape, dtype name, C-order bytes)``, ``bfloat16``
included), and flax's chunked arrays (a map marked
``__msgpack_chunked_array__`` whose ``shape`` and ``chunks`` are tuples
written as maps keyed ``"0"``, ``"1"`` ...). Arrays come back as CPU
tensors, each array's bytes read from the file straight into its tensor;
empty maps (optax's masked leaves) stay empty dicts. :func:`load_pytree` tells
the two formats apart by their first bytes, so :func:`load_checkpoint` reads a
JAX checkpoint directory as it stands: ``_target_`` names of the JAX package
in its ``meta.yaml`` become the port's, whose modules keep the same names and
places, and a JAX ``train_gpt`` optimizer state becomes the port's
(:func:`optax_state_dict`). :func:`save_pytree` ``(format="msgpack")``
writes the same bytes as ``flax.serialization.to_bytes``; the port's apps keep
``torch.save``.

A JAX ClipGPT step checkpoint holds the trainable leaves only and records the
JAX PRNG key that drew the frozen ones, which this package cannot draw: its
frozen leaves come from a full tree passed as ``base``
(:func:`trainable_over_base`).
"""

from __future__ import annotations

import io
import struct
import typing as tp
from pathlib import Path

import numpy as np
import torch
import yaml

from summer_clip_torch.engine.quant import map_tree

__all__ = ["save_pytree", "load_pytree", "msgpack_restore", "msgpack_serialize", "filter_tree",
           "merge_tree", "save_checkpoint", "load_checkpoint", "optax_state_dict",
           "trainable_over_base", "MAX_CHUNK_SIZE", "is_port_state"]

MAX_CHUNK_SIZE = 2 ** 30     # flax.serialization's: an array of more bytes is written in chunks
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_ZIP_MAGIC = b"PK\x03\x04"
_DTYPES = {name: getattr(torch, name) for name in (
    "float64", "float32", "float16", "bfloat16", "int64", "int32", "int16", "int8",
    "uint64", "uint32", "uint16", "uint8", "bool", "complex64", "complex128")}
_DTYPE_NAMES = {dt: name for name, dt in _DTYPES.items()}


def _to_cpu(x: tp.Any) -> tp.Any:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


# ---------------------------------------------------------------------------
# msgpack, the subset flax.serialization writes
# ---------------------------------------------------------------------------
class _Reader:
    def __init__(self, f: tp.BinaryIO):
        self.f = f
        self.pos = 0

    def take(self, n: int) -> bytes:
        data = self.f.read(n)
        if len(data) != n:
            raise ValueError(f"msgpack: the data ends at byte {self.pos + len(data)}, "
                             f"{n} more expected")
        self.pos += n
        return data

    def unpack(self, fmt: str) -> tp.Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def fill(self, tensor: torch.Tensor) -> None:
        """Read ``tensor``'s bytes from the stream into its memory."""
        view = memoryview(tensor.reshape(-1).view(torch.uint8).numpy())
        got = 0
        while got < len(view):
            n = self.f.readinto(view[got:])
            if not n:
                raise ValueError(f"msgpack: an array's data ends at byte {self.pos + got}")
            got += n
        self.pos += got


_UINT = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q"}
_INT = {0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_LEN = {1: ">B", 2: ">H", 4: ">I"}
_BIN = {0xc4: 1, 0xc5: 2, 0xc6: 4}
_STR = {0xd9: 1, 0xda: 2, 0xdb: 4}
_ARRAY = {0xdc: 2, 0xdd: 4}
_MAP = {0xde: 2, 0xdf: 4}
_EXT = {0xc7: 1, 0xc8: 2, 0xc9: 4}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_FIXEXT_CODE = {n: code for code, n in _FIXEXT.items()}


def _decode(r: _Reader) -> tp.Any:
    b = r.take(1)[0]
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _decode_map(r, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return [_decode(r) for _ in range(b & 0x0f)]
    if 0xa0 <= b <= 0xbf:
        return r.take(b & 0x1f).decode("utf-8")
    if b in (0xc0, 0xc2, 0xc3):
        return {0xc0: None, 0xc2: False, 0xc3: True}[b]
    if b in _UINT:
        return r.unpack(_UINT[b])
    if b in _INT:
        return r.unpack(_INT[b])
    if b in (0xca, 0xcb):
        return r.unpack(">f" if b == 0xca else ">d")
    if b in _STR:
        return r.take(r.unpack(_LEN[_STR[b]])).decode("utf-8")
    if b in _BIN:
        return r.take(r.unpack(_LEN[_BIN[b]]))
    if b in _ARRAY:
        return [_decode(r) for _ in range(r.unpack(_LEN[_ARRAY[b]]))]
    if b in _MAP:
        return _decode_map(r, r.unpack(_LEN[_MAP[b]]))
    if b in _FIXEXT or b in _EXT:
        n = _FIXEXT[b] if b in _FIXEXT else r.unpack(_LEN[_EXT[b]])
        return _decode_ext(r, r.unpack(">b"), n)
    raise ValueError(f"msgpack: byte 0x{b:02x} at {r.pos - 1} starts no object")


def _decode_map(r: _Reader, n: int) -> tp.Any:
    out = {}
    for _ in range(n):
        key = _decode(r)
        out[key] = _decode(r)
    if _CHUNKED in out:    # flax's chunked array: shape and chunks are tuples as maps
        shape = [out["shape"][str(i)] for i in range(len(out["shape"]))]
        chunks = [out["chunks"][str(i)].reshape(-1) for i in range(len(out["chunks"]))]
        return torch.cat(chunks).reshape(shape)
    return out


def _decode_ext(r: _Reader, code: int, n: int) -> tp.Any:
    start = r.pos
    if code == _EXT_COMPLEX:
        re, im = _decode(r)
        value = complex(re, im)
    elif code in (_EXT_NDARRAY, _EXT_NPSCALAR):
        if r.take(1)[0] != 0x93:
            raise ValueError(f"msgpack: the ndarray at byte {start} is not (shape, dtype, data)")
        shape, name = _decode(r), _decode(r)
        name = name.decode("ascii") if isinstance(name, bytes) else name
        if name not in _DTYPES:
            raise ValueError(f"msgpack: the ndarray at byte {start} has dtype {name!r}, "
                             f"which the port does not read")
        b = r.take(1)[0]
        if b not in _BIN:
            raise ValueError(f"msgpack: the ndarray at byte {start} carries no bytes")
        nbytes = r.unpack(_LEN[_BIN[b]])
        value = torch.empty(shape, dtype=_DTYPES[name])
        if nbytes != value.numel() * value.element_size():
            raise ValueError(f"msgpack: the ndarray at byte {start} ({name} {shape}) "
                             f"carries {nbytes} bytes")
        r.fill(value)
    else:
        raise ValueError(f"msgpack: extension type {code} at byte {start} is not flax's")
    if r.pos - start != n:
        raise ValueError(f"msgpack: extension at byte {start} is {n} bytes, read {r.pos - start}")
    return value


def _restore(f: tp.BinaryIO) -> tp.Any:
    r = _Reader(f)
    tree = _decode(r)
    if f.read(1):
        raise ValueError(f"msgpack: data after the object's end at byte {r.pos}")
    return tree


def msgpack_restore(data: bytes) -> tp.Any:
    """``flax.serialization.msgpack_restore``: the tree in ``data``, arrays as
    CPU tensors (a numpy scalar as a 0-d tensor)."""
    return _restore(io.BytesIO(data))


def _header(w, n: int, fix: tp.Optional[int], fix_max: int, codes: tp.Sequence[tp.Tuple[int, int]]
            ) -> None:
    """A length header: the fix form below ``fix_max``, else the first of
    ``codes`` (code, width) whose width holds ``n``."""
    if fix is not None and n <= fix_max:
        w(bytes([fix | n]))
        return
    for code, width in codes:
        if n < 1 << (8 * width):
            w(bytes([code]) + struct.pack(_LEN[width], n))
            return
    raise ValueError(f"msgpack: {n} is too long")


def _array_bytes(x: tp.Union[torch.Tensor, np.ndarray]) -> tp.Tuple[list, str, memoryview]:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype not in _DTYPE_NAMES:
            raise ValueError(f"msgpack: no flax dtype for {t.dtype}")
        return list(t.shape), _DTYPE_NAMES[t.dtype], memoryview(
            t.reshape(-1).view(torch.uint8).numpy())
    a = np.asarray(x, order="C")    # np.ascontiguousarray would make a 0-d array 1-d
    return list(a.shape), a.dtype.name, memoryview(a.reshape(-1).view(np.uint8))


def _chunk(x: tp.Union[torch.Tensor, np.ndarray]) -> tp.Optional[dict]:
    """flax's ``_chunk`` of an array of more than ``MAX_CHUNK_SIZE`` bytes."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    numel = x.numel() if isinstance(x, torch.Tensor) else x.size
    if numel * itemsize <= MAX_CHUNK_SIZE:
        return None
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): flat[s:s + size]
                       for i, s in enumerate(range(0, numel, size))}}


def _encode(x: tp.Any, w, chunk: bool = True) -> None:
    """msgpack of ``x`` through ``w``, byte for byte what
    ``msgpack.packb(x, default=flax's ext packer, strict_types=True)`` gives
    after flax's chunking of dict values. Arrays and numpy scalars come first:
    ``np.float64`` is a ``float``, and ``strict_types`` sends it to flax's packer."""
    if isinstance(x, (torch.Tensor, np.ndarray, np.generic)):
        chunked = _chunk(x) if chunk and not isinstance(x, np.generic) else None
        if chunked is not None:
            _encode(chunked, w)
            return
        shape, name, data = _array_bytes(np.asarray(x) if isinstance(x, np.generic) else x)
        inner = io.BytesIO()
        inner.write(b"\x93")
        _encode(shape, inner.write)
        _encode(name, inner.write)
        _header(inner.write, len(data), None, 0, list(_BIN.items()))
        _encode_ext(w, _EXT_NPSCALAR if isinstance(x, np.generic) else _EXT_NDARRAY,
                    [inner.getvalue(), data])
    elif x is None:
        w(b"\xc0")
    elif isinstance(x, bool):
        w(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int):
        if 0 <= x <= 0x7f or -32 <= x < 0:
            w(struct.pack(">b" if x < 0 else ">B", x))
        elif x > 0:
            code, fmt = next((c, f) for c, f in _UINT.items() if x < 1 << (8 * struct.calcsize(f)))
            w(bytes([code]) + struct.pack(fmt, x))
        else:
            code, fmt = next((c, f) for c, f in _INT.items()
                             if x >= -(1 << (8 * struct.calcsize(f) - 1)))
            w(bytes([code]) + struct.pack(fmt, x))
    elif isinstance(x, float):
        w(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        data = x.encode("utf-8")
        _header(w, len(data), 0xa0, 31, list(_STR.items()))
        w(data)
    elif isinstance(x, (bytes, bytearray, memoryview)):
        _header(w, len(x), None, 0, list(_BIN.items()))
        w(x)
    elif isinstance(x, tp.Mapping):
        _header(w, len(x), 0x80, 15, list(_MAP.items()))
        for k, v in x.items():
            _encode(k, w)
            _encode(v, w)
    elif isinstance(x, (list, tuple)):
        _header(w, len(x), 0x90, 15, list(_ARRAY.items()))
        for v in x:
            _encode(v, w, chunk=False)
    elif isinstance(x, complex):
        payload = io.BytesIO()
        _encode([x.real, x.imag], payload.write)
        _encode_ext(w, _EXT_COMPLEX, [payload.getvalue()])
    else:
        raise TypeError(f"msgpack: cannot write {type(x).__name__}")


def _encode_ext(w, code: int, parts: tp.Sequence[tp.Union[bytes, memoryview]]) -> None:
    n = sum(len(p) for p in parts)
    if n in _FIXEXT_CODE:
        w(bytes([_FIXEXT_CODE[n]]))
    else:
        _header(w, n, None, 0, list(_EXT.items()))
    w(struct.pack(">b", code))
    for p in parts:
        w(p)


def msgpack_serialize(tree: tp.Any) -> bytes:
    """The bytes ``flax.serialization.to_bytes`` writes for a tree of dicts
    (keys in their insertion order)."""
    out = io.BytesIO()
    _encode(tree, out.write)
    return out.getvalue()


# ---------------------------------------------------------------------------
# trees on disk
# ---------------------------------------------------------------------------
def save_pytree(path: tp.Union[str, Path], tree: tp.Any, format: str = "torch") -> None:
    """``torch.save`` of the tree's CPU tensors; ``format="msgpack"`` writes
    what the JAX package's ``save_pytree`` writes (the tests and
    ``chip_smoke.py`` use it to stand for a JAX run's files)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if format == "msgpack":
        with open(path, "wb") as f:
            _encode(tree, f.write)
    elif format == "torch":
        torch.save(map_tree(lambda _, x: _to_cpu(x), tree), path)
    else:
        raise ValueError(f"save_pytree writes format 'torch' or 'msgpack', not {format!r}")


def load_pytree(path: tp.Union[str, Path]) -> tp.Any:
    """A tree that ``torch.save`` (the port) or ``flax.serialization``
    msgpack (the JAX package) wrote, told apart by the file's first bytes."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(4)
        if head == _ZIP_MAGIC:
            return torch.load(path, map_location="cpu", weights_only=True)
        if head and (0x80 <= head[0] <= 0x8f or head[0] in _MAP):
            f.seek(0)
            return _restore(f)
    raise ValueError(f"{path}: neither a torch.save archive nor a msgpack map "
                     f"(first bytes {head!r})")


def filter_tree(tree: tp.Any, keep: tp.Callable[[tp.Tuple[str, ...]], bool]) -> dict:
    """Nested-dict subset of ``tree`` whose paths satisfy ``keep``."""
    out: dict = {}

    def visit(path, leaf):
        if keep(path):
            cur = out
            for n in path[:-1]:
                cur = cur.setdefault(n, {})
            cur[path[-1]] = leaf
        return leaf

    map_tree(visit, tree)
    return out


def merge_tree(base: tp.Any, overlay: dict) -> tp.Any:
    """Return ``base`` with leaves present in ``overlay`` replaced."""
    def rec(b, o):
        if isinstance(o, dict) and isinstance(b, dict):
            out = dict(b)
            for k, v in o.items():
                out[k] = rec(b[k], v) if k in b else v
            return out
        return o
    return rec(base, overlay)


def _leaf(tree: tp.Any, path: tp.Sequence[str]) -> tp.Any:
    """The leaf at ``path``, or None."""
    for k in path:
        if not isinstance(tree, tp.Mapping) or k not in tree:
            return None
        tree = tree[k]
    return None if isinstance(tree, tp.Mapping) else tree


def _port_targets(node: tp.Any) -> tp.Any:
    """``_target_`` names of the JAX package as the port's: the port keeps
    every ported module's name and place."""
    if isinstance(node, dict):
        return {k: ("summer_clip_torch." + v[len("summer_clip_tpu."):]
                    if k == "_target_" and isinstance(v, str) and v.startswith("summer_clip_tpu.")
                    else _port_targets(v)) for k, v in node.items()}
    if isinstance(node, list):
        return [_port_targets(v) for v in node]
    return node


def save_checkpoint(ckpt_dir: tp.Union[str, Path], *, params: tp.Any = None,
                    opt_state: tp.Any = None, meta: tp.Optional[dict] = None,
                    keep: tp.Optional[tp.Callable[[tp.Tuple[str, ...]], bool]] = None,
                    step: tp.Optional[int] = None) -> Path:
    """Save {model.ckpt, optimizer.ckpt, meta.yaml} under ckpt_dir[/step_N]."""
    ckpt_dir = Path(ckpt_dir)
    if step is not None:
        ckpt_dir = ckpt_dir / f"step_{step}"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    if params is not None:
        save_pytree(ckpt_dir / "model.ckpt", filter_tree(params, keep) if keep else params)
    if opt_state is not None:
        save_pytree(ckpt_dir / "optimizer.ckpt", opt_state)
    if meta is not None:
        (ckpt_dir / "meta.yaml").write_text(yaml.safe_dump(meta, sort_keys=False))
    return ckpt_dir


def is_port_state(state: tp.Any) -> bool:
    return isinstance(state, tp.Mapping) and (
        {"count", "optimizer"} <= set(state) or {"calls", "inner"} <= set(state))


def load_checkpoint(ckpt_dir: tp.Union[str, Path], *, params_target: tp.Any = None,
                    opt_target: tp.Any = None,
                    named_params: tp.Optional[tp.Mapping[str, torch.Tensor]] = None) -> dict:
    """Load whatever a checkpoint directory holds, the port's or the JAX
    package's; a trainable-only ``model.ckpt`` is merged into
    ``params_target`` when one is given, and ``optimizer.ckpt`` is restored
    into ``opt_target`` (an optimizer of ``engine/optim``, through its
    ``load_state_dict``) when one is given. A JAX optimizer state goes through
    :func:`optax_state_dict`, which needs the parameters by name
    (``named_params``, the model's ``named_parameters()``)."""
    ckpt_dir = Path(ckpt_dir)
    out: dict = {}
    model_path = ckpt_dir / "model.ckpt"
    if model_path.exists():
        saved = load_pytree(model_path)
        out["params"] = merge_tree(params_target, saved) if params_target is not None else saved
    opt_path = ckpt_dir / "optimizer.ckpt"
    if opt_path.exists():
        out["opt_state"] = load_pytree(opt_path)
        if opt_target is not None:
            state = out["opt_state"]
            if not is_port_state(state):
                if named_params is None:
                    raise ValueError(f"{opt_path} is an optax state: restoring it needs the "
                                     f"parameters by name (named_params=)")
                state = optax_state_dict(state, opt_target, named_params)
            opt_target.load_state_dict(state)
    meta_path = ckpt_dir / "meta.yaml"
    if meta_path.exists():
        out["meta"] = _port_targets(yaml.safe_load(meta_path.read_text()))
    return out


# ---------------------------------------------------------------------------
# the JAX package's optimizer state and trainable-only trees
# ---------------------------------------------------------------------------
def _at(tree: tp.Any, path: tp.Sequence[str], what: str) -> tp.Any:
    for i, k in enumerate(path):
        if not isinstance(tree, tp.Mapping) or k not in tree:
            raise ValueError(f"optimizer.ckpt: no {'/'.join(path[:i + 1])} ({what}); the port "
                             f"reads MultiSteps(chain(clip_by_global_norm, multi_transform("
                             f"adamw per label, set_to_zero))) as JAX train_gpt builds it")
        tree = tree[k]
    return tree


def _leaves(tree: tp.Any, path: tp.Tuple[str, ...] = ()) -> tp.Iterator[tp.Tuple[str, tp.Any]]:
    """(dot-joined path, leaf) of a nested dict; empty dicts (masked) yield nothing."""
    if isinstance(tree, tp.Mapping):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield ".".join(path), tree


def _unstacked(tree: tp.Any) -> tp.Any:
    """A tree of the JAX app's stacked layouts (``{"rest", "stacked"}``:
    ``scan_layers`` leaves ``(1, L, ...)``, ``pp`` ``(S, L/S, ...)``) on the
    standard paths; any other tree as it is."""
    if isinstance(tree, tp.Mapping) and set(tree) == {"rest", "stacked"}:
        from summer_clip_torch.parallel.pp import unstack_block_params

        return unstack_block_params(tree["rest"], tree["stacked"])
    return tree


def optax_state_dict(state: tp.Mapping[str, tp.Any], tx: tp.Any,
                     named_params: tp.Mapping[str, torch.Tensor]) -> dict:
    """A JAX ``train_gpt`` ``optimizer.ckpt`` as ``tx.state_dict()`` of the
    port's optimizer built for the same run (``engine/optim.adamw(...,
    frozen=...)``, in a ``GradAccum`` when the run accumulates).

    The JAX state is ``flax.serialization.to_state_dict`` of
    ``[MultiSteps](chain(clip_by_global_norm, multi_transform({"decay": adamw,
    "no_decay": adamw, "freeze": set_to_zero})))`` (the chain without clipping,
    the MultiSteps without accumulation): the accumulator over every leaf, and
    per label Adam's count and moments over the whole tree with ``{}`` where
    the label masks a leaf; the trees of a stacked layout (``scan_layers``,
    ``pp``: the state mirrors ``{"rest", "stacked"}``) are unstacked onto the
    standard paths first. Each updated parameter takes the moments of the
    label that holds them (checked against its group's weight decay); every
    layout the port's optimizer does not match raises, naming the path."""
    from summer_clip_torch.engine.optim import GradAccum

    accum = isinstance(tx, GradAccum)
    opt = tx.inner if accum else tx
    if ("mini_step" in state) != accum:
        raise ValueError("optimizer.ckpt: " + (
            f"no MultiSteps state (mini_step), but the port's optimizer accumulates over "
            f"{tx.every} calls" if accum else
            "a MultiSteps state (mini_step), but the port's optimizer does not accumulate"))
    inner = _at(state, ["inner_opt_state"], "MultiSteps' inner state") if accum else state
    if opt.grad_clip_norm is not None:
        if _at(inner, ["0"], "clip_by_global_norm's state"):
            raise ValueError("optimizer.ckpt: 0 (clip_by_global_norm) holds state")
        inner = _at(inner, ["1"], "the multi_transform after clip_by_global_norm")
    labels = _at(inner, ["inner_states"], "multi_transform's states per label")

    moments: tp.Dict[str, tp.Tuple[str, torch.Tensor, torch.Tensor]] = {}
    counts = {int(state["gradient_step"])} if accum else set()
    for label, sub in labels.items():
        sub = _at(sub, ["inner_state"], f"label {label}")
        if not sub:       # set_to_zero
            continue
        adam = _at(sub, ["0"], f"label {label}'s scale_by_adam")
        counts |= {int(adam["count"]), int(_at(sub, ["2", "count"], f"label {label}'s schedule"))}
        nu = dict(_leaves(_unstacked(_at(adam, ["nu"], f"label {label}'s second moments"))))
        for name, mu in _leaves(_unstacked(_at(adam, ["mu"], f"label {label}'s first moments"))):
            if name in moments:
                raise ValueError(f"optimizer.ckpt: {name} has moments in labels "
                                 f"{moments[name][0]} and {label}")
            moments[name] = (label, mu, nu[name])
    if len(counts) != 1:
        raise ValueError(f"optimizer.ckpt: the update counts disagree ({sorted(counts)})")
    count = counts.pop()

    names = {id(p): n for n, p in named_params.items()}
    any_decay = any(g["weight_decay"] for g in opt.optimizer.param_groups)
    torch_state = {}
    index = 0
    for group in opt.optimizer.param_groups:
        for p in group["params"]:
            name = names.get(id(p))
            if name is None or name not in moments:
                raise ValueError(f"optimizer.ckpt: no Adam moments for the port's updated "
                                 f"leaf {name or '(unnamed)'}")
            label, mu, nu = moments.pop(name)
            if any_decay and (label == "decay") != bool(group["weight_decay"]):
                raise ValueError(f"optimizer.ckpt: {name} is in label {label}, but the port "
                                 f"decays it by {group['weight_decay']}")
            if tuple(mu.shape) != tuple(p.shape):
                raise ValueError(f"optimizer.ckpt: {name} has moments of shape "
                                 f"{tuple(mu.shape)}, the parameter {tuple(p.shape)}")
            torch_state[index] = {"step": torch.tensor(float(count)),
                                  "exp_avg": mu.to(p.dtype), "exp_avg_sq": nu.to(p.dtype)}
            index += 1
    if moments:
        raise ValueError(f"optimizer.ckpt: moments for leaves the port's optimizer does not "
                         f"update: {sorted(moments)[:6]}")
    inner_state = {"count": count, "optimizer": {
        "state": torch_state, "param_groups": opt.optimizer.state_dict()["param_groups"]}}
    if not accum:
        return inner_state
    mini = int(state["mini_step"])
    acc = None
    if mini:
        grads = dict(_leaves(_unstacked(_at(state, ["acc_grads"], "MultiSteps' accumulator"))))
        missing = [names[id(p)] for p in opt.grad_params if names.get(id(p)) not in grads]
        if missing:
            raise ValueError(f"optimizer.ckpt: acc_grads lacks {missing[:6]}")
        acc = [grads[names[id(p)]] for p in opt.grad_params]
    return {"calls": count * tx.every + mini, "acc": acc, "inner": inner_state}


def trainable_over_base(loaded: tp.Mapping[str, tp.Any], base: tp.Optional[tp.Union[str, Path]],
                        names: tp.Sequence[str], where: tp.Any) -> dict:
    """The tree a trainable-only checkpoint (``loaded``, from
    :func:`load_checkpoint` of ``where``) installs: its leaves over those of
    ``base``, a file of the whole tree (msgpack or torch), which must then hold
    every parameter of ``names`` (dot-joined paths). Without ``base`` the
    checkpoint's own leaves; a JAX ClipGPT step checkpoint (``init_key`` in
    its meta, no ``init_seed``) then raises, naming the frozen leaves it lacks:
    JAX drew them from that key, which this package cannot draw."""
    params = loaded.get("params") or {}
    meta = loaded.get("meta") or {}
    if base is None:
        if "init_key" in meta and "init_seed" not in meta:
            missing = [n for n in names if _leaf(params, n.split(".")) is None]
            raise ValueError(
                f"{where} is a JAX step checkpoint: it holds the trainable leaves only, and "
                f"JAX drew the {len(missing)} frozen ones ({', '.join(missing[:4])}, ...) "
                f"from the threefry key its meta records (init_key), which this package "
                f"cannot draw; pass base=<a msgpack or torch file of the whole tree>")
        return params
    tree = merge_tree(load_pytree(base), params)
    missing = [n for n in names if _leaf(tree, n.split(".")) is None]
    if missing:
        raise ValueError(f"base {base} with {where} lacks {len(missing)} leaves: "
                         f"{', '.join(missing[:4])}")
    return tree
