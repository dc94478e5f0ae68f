"""The whole GPT-2 block stack for one decoded token: plain version + CUDA kernel.

Counterpart of ``summer_clip_tpu/ops/decode_block.py``. The unfused int8 decode
path runs four streamed products a block plus attention, each a launch and a
Python call of its own; this module runs the entire stack for one token of up
to eight independent streams in one launch, over int8 (or bf16) weights as
stored and int8 (or bf16) KV rings with a scale per row:

- :func:`pack_core_params` -- stack a core tree's block parameters into
  ``(L, K, N)`` slabs in their stored orientation (``store``: int8 or bf16);
- :func:`init_mega_kv`, :func:`cache_to_mega`, :func:`mega_update_kv` -- the
  rings: ``(L, T, D)`` for the legacy single stream or ``(L, B, T, D)``, T padded
  to a multiple of 256 (the store format); the update writes in place;
- :func:`decode_block_reference` -- the plain version, the JAX oracle's
  arithmetic with its rounding points;
- :func:`decode_block` -- K8, CUDA source ``csrc/decode_kernels.cu``; replaces
  the TPU kernel ``decode_block`` (ops/decode_block.py:723). One launch of a
  persistent grid of 4-CTA clusters; ``index`` and ``pad`` are read on the
  device. :func:`stage_plan` picks each product's column tile and TMA box from
  its geometry, and :func:`weight_boxes` walks a CTA's weight stream as the
  kernel does.
- :func:`mega_legal` -- the routing rule of ``generation.megakernel=auto``, the
  JAX package's. Its stage plan (VMEM slabs, T chunks) has no counterpart here.
- :func:`mega_from_numpy` -- the JAX package's packed slabs or rings, as numpy
  arrays, as the port's tensors (a typed copy: same keys, same layouts).

On a CPU tensor :func:`decode_block` runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from summer_clip_torch.ops import _lib
from summer_clip_torch.ops.gemv import _scratch, box_rows, is_qleaf, matmul_reference

__all__ = ["mega_legal", "pack_core_params", "init_mega_kv", "cache_to_mega", "mega_update_kv",
           "mega_from_numpy", "decode_block", "decode_block_reference", "barriers", "grid_blocks",
           "stage_plan", "weight_boxes", "MAX_STREAMS", "CLUSTER"]

MAX_STREAMS = 8      # streams one launch carries
_TC = 256            # ring rows are padded to a multiple of this; the online softmax's pass
_CHUNK_CAP = 4 * 1024 * 1024   # the JAX package's slab cap: part of the routing rule only
_NEG = -1e30
CLUSTER = 4          # CTAs of a K8 cluster: the K split of a product, the row split of a pass
_PLAN_CLUSTERS = 32  # clusters the tile planner deals to (an H100 holds 32-33 such clusters)
# a tile's fixed cost (box waits, sums, its cluster barrier, the epilogue: ~1.5 us on
# an H100 at one stream, against ~1 us of products a 128-byte tile) in bytes of width
_TILE_COST = 192
_SLOTS = 8           # boxes K8's ring holds (kSlots of csrc/decode_kernels.cu): a tile's at most

KV = tp.Dict[str, torch.Tensor]


def _chunk(k_dim: int, n_dim: int, itemsize: int) -> int:
    best = 0
    for c in range(128, k_dim + 1, 128):
        if k_dim % c == 0 and c * n_dim * itemsize <= _CHUNK_CAP:
            best = c
    return best if best else (128 if k_dim % 128 == 0 else 0)


def mega_legal(d: int, h: int, nh: int) -> bool:
    """Geometry that ``megakernel=auto`` sends to K8, by the JAX package's rule
    (gpt2, medium and large pass; xl's D = 1600 does not). The CUDA kernel also
    needs heads of 64 features, which every GPT-2 has; :func:`decode_block`
    raises on anything else."""
    return (d % 128 == 0 and h % 128 == 0 and d % nh == 0 and nh <= 128
            and _chunk(d, 3 * d, 1) > 0 and _chunk(h, d, 1) > 0)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------
def _stored(leaf, store: str) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """(values, scale row) of one (K, N) kernel leaf in the requested storage;
    an int8 leaf passes through as quantised."""
    if is_qleaf(leaf):
        if store == "int8":
            return leaf.q, leaf.scale.reshape(1, -1)
        wide = leaf.q.to(torch.float32) * leaf.scale
        return wide.to(torch.bfloat16), torch.ones((1, wide.shape[-1]), dtype=torch.float32,
                                                   device=wide.device)
    if store == "int8":
        leaf = leaf.to(torch.float32)
        amax = leaf.abs().amax(dim=tuple(range(leaf.dim() - 1)), keepdim=True)
        # times the f32 reciprocal: what the JAX package's jitted program computes
        scale = amax.clamp_min(1e-12) * (1.0 / 127.0)
        q = torch.round(leaf / scale).clamp(-127, 127).to(torch.int8)
        return q, scale.reshape(1, -1)
    return leaf.to(torch.bfloat16), torch.ones((1, leaf.shape[-1]), dtype=torch.float32,
                                               device=leaf.device)


def pack_core_params(core: tp.Mapping[str, tp.Any], n_layer: int, *,
                     store: str = "int8") -> tp.Dict[str, torch.Tensor]:
    """Stack the block parameters of a core tree (``model.tree()["core"]``) into
    the kernel's layout. Weight leaves may be plain or int8 ``QLeaf``s. Every
    matrix keeps its (K, N) orientation, so a K chunk is a contiguous slab.
    ``store``: "int8" (dense leaves quantised per output column) or "bf16"."""
    if store not in ("int8", "bf16"):
        raise ValueError(f"store: expected 'int8' or 'bf16', got {store!r}")
    rows: tp.Dict[str, list] = {k: [] for k in (
        "wqkv", "sqkv", "bqkv", "wproj", "sproj", "bproj", "w1", "s1", "b1", "w2", "s2", "b2", "ln")}

    def add(name: str, wkey: str, leaf: tp.Mapping[str, tp.Any]) -> None:
        w, s = _stored(leaf["kernel"], store)
        rows[wkey].append(w)
        rows["s" + name].append(s)
        rows["b" + name].append(leaf["bias"].to(torch.float32).reshape(1, -1))

    for i in range(n_layer):
        blk = core[f"h_{i}"]
        add("qkv", "wqkv", blk["attn"]["c_attn"])
        add("proj", "wproj", blk["attn"]["c_proj"])
        add("1", "w1", blk["mlp_c_fc"])
        add("2", "w2", blk["mlp_c_proj"])
        rows["ln"].append(torch.stack([blk["ln_1"]["scale"], blk["ln_1"]["bias"],
                                       blk["ln_2"]["scale"], blk["ln_2"]["bias"]]).to(torch.float32))
    return {k: torch.stack(v).contiguous() for k, v in rows.items()}


def _padded(max_len: int) -> int:
    return -(-max_len // _TC) * _TC


def init_mega_kv(n_layer: int, d: int, max_len: int, kv_dtype: torch.dtype = torch.int8,
                 batch: tp.Optional[int] = None, device=None) -> KV:
    """Empty rings, T padded up to a multiple of 256. ``batch=None`` keeps the
    legacy single-stream (L, T, D) layout; ``batch=B`` gives (L, B, T, D)."""
    t = _padded(max_len)
    shp = (n_layer, t, d) if batch is None else (n_layer, batch, t, d)
    sshp = shp[:-1] + (1,)
    return {"k": torch.zeros(shp, dtype=kv_dtype, device=device),
            "v": torch.zeros(shp, dtype=kv_dtype, device=device),
            "ks": torch.ones(sshp, dtype=torch.float32, device=device),
            "vs": torch.ones(sshp, dtype=torch.float32, device=device)}


def _quant_rows(x: torch.Tensor, kv_dtype: torch.dtype) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """KV quantisation per row (per token): (..., T, D) -> values and scales."""
    if kv_dtype == torch.int8:
        amax = x.abs().amax(dim=-1, keepdim=True)
        scale = amax.clamp_min(1e-12) * (1.0 / 127.0)   # as the jitted JAX program computes it
        q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
        return q, scale.to(torch.float32)
    return x.to(kv_dtype), torch.ones(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)


def cache_to_mega(cache: tp.Sequence[tp.Mapping[str, tp.Any]], max_len: int,
                  kv_dtype: torch.dtype = torch.int8, batched: bool = False) -> KV:
    """A standard per-layer decode cache (``init_cache`` layout) after prefill as
    stacked rings. ``batched=False`` converts row 0 only (legacy (L, T, D));
    ``batched=True`` keeps every row as a stream of its own ((L, B, T, D))."""
    t = _padded(max_len)
    pick = (lambda a: a) if batched else (lambda a: a[0])
    ks = torch.stack([pick(c["k"]) for c in cache]).to(torch.float32)
    vs = torch.stack([pick(c["v"]) for c in cache]).to(torch.float32)
    grow = (0, 0, 0, t - ks.shape[-2])
    kq, ksc = _quant_rows(F.pad(ks, grow), kv_dtype)
    vq, vsc = _quant_rows(F.pad(vs, grow), kv_dtype)
    return {"k": kq, "v": vq, "ks": ksc, "vs": vsc}


def _index_vector(index, batch: int, device) -> torch.Tensor:
    return torch.as_tensor(index, device=device).to(torch.long).reshape(-1).expand(batch)


def mega_update_kv(kv: KV, kq: torch.Tensor, vq: torch.Tensor, ksn: torch.Tensor,
                   vsn: torch.Tensor, index) -> KV:
    """Write the fresh rows into the rings at each stream's position, in place
    (the counterpart of ``dynamic_update_slice`` in a scan carry), and return
    ``kv``. ``index``: scalar (legacy (L, T, D) rings) or (B,) positions; a row
    out of range clamps to the ring's last row, which is the engine's rule for
    the junk writes of free and retired slots. Nothing is read back."""
    t = kv["k"].shape[-2]
    if kv["k"].dim() == 3:
        slot = _index_vector(index, 1, kv["k"].device).clamp(0, t - 1)
        for name, new in (("k", kq), ("v", vq), ("ks", ksn), ("vs", vsn)):
            kv[name].index_copy_(1, slot, new)
        return kv
    batch = kv["k"].shape[1]
    slot = _index_vector(index, batch, kv["k"].device).clamp(0, t - 1)
    rows = torch.arange(batch, device=slot.device)
    for name, new in (("k", kq), ("v", vq), ("ks", ksn), ("vs", vsn)):
        kv[name][:, rows, slot] = new
    return kv


def mega_from_numpy(arrays: tp.Mapping[str, tp.Any], device=None) -> tp.Dict[str, torch.Tensor]:
    """The JAX package's ``pack_core_params`` output or its ring dict, as numpy
    arrays (bf16 as ``ml_dtypes`` arrays or anything with ``astype``), as the
    port's tensors: same keys, same layouts, values bit for bit."""
    out = {}
    for key, a in arrays.items():
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
        out[str(key)] = t.to(device) if device is not None else t
    return out


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------
def _ln_rows(x: torch.Tensor, scale_row: torch.Tensor, bias_row: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of (R, D) f32 rows in f32."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale_row + bias_row


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16)


def _reference_single(x, packed, kv, index, nh: int, pad):
    """One stream: ``x`` (1, D), rings (L, T, D). The online softmax takes the
    ring 256 rows at a time, the fresh token first, with the kernel's rounding
    points: bf16 K = bf16(k) * bf16(ks), bf16(q / sqrt(hd)), f32 scores,
    bf16(bf16(p * vs) * bf16(v)) summed in f32, one division by l at the end.
    The head routing is written as two products against a one-hot (D, nh)
    matrix, as in the JAX oracle, so the f32 sums run in the same order."""
    n_layer, d, _ = packed["wproj"].shape
    hd = d // nh
    t = kv["k"].shape[1]
    kv_dtype = kv["k"].dtype
    dev = x.device
    head_mask = (torch.arange(d, device=dev)[:, None] // hd
                 == torch.arange(nh, device=dev)[None, :]).to(torch.float32)   # (D, nh)
    e_mat = head_mask.t().contiguous()                                          # (nh, D)
    positions = torch.arange(t, device=dev)[:, None]
    pos_valid = positions < index
    if pad is not None:
        pos_valid = pos_valid & (positions >= pad)
    neg = torch.tensor(_NEG, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    kqs, vqs, ksns, vsns = [], [], [], []
    for i in range(n_layer):
        ln = packed["ln"][i]
        u = _ln_rows(x, ln[0:1], ln[1:2])
        qkv = matmul_reference(u, packed["wqkv"][i]) * packed["sqkv"][i] + packed["bqkv"][i]
        q, kn, vn = qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:]
        kq, ksn = _quant_rows(kn, kv_dtype)
        vq, vsn = _quant_rows(vn, kv_dtype)
        kqs.append(kq), vqs.append(vq), ksns.append(ksn), vsns.append(vsn)

        qbd = q.t() * head_mask / float(np.sqrt(hd))                 # (D, nh) f32
        m = matmul_reference(kq.to(torch.float32) * ksn, qbd)        # the fresh row's score (1, nh)
        lsum = torch.ones_like(m)
        acc = vsn * vq.to(torch.float32)                             # the fresh row as stored
        for a in range(t // _TC):
            sl = slice(a * _TC, (a + 1) * _TC)
            kc = _bf16(kv["k"][i, sl]) * _bf16(kv["ks"][i, sl])      # (Tc, D) bf16
            valid = pos_valid[sl]
            sc = torch.where(valid, matmul_reference(kc, qbd), neg)  # (Tc, nh)
            mnew = torch.maximum(m, sc.max(dim=0, keepdim=True).values)
            alpha = torch.exp(m - mnew)
            p = torch.where(valid, torch.exp(sc - mnew), zero)
            lsum = lsum * alpha + p.sum(dim=0, keepdim=True)
            pfull = _bf16(torch.matmul(_bf16(p * kv["vs"][i, sl]).to(torch.float32), e_mat))
            su = pfull * _bf16(kv["v"][i, sl])                       # bf16 product, rounded
            acc = acc * torch.matmul(alpha, e_mat) + su.to(torch.float32).sum(dim=0, keepdim=True)
            m = mnew
        att = acc / torch.matmul(lsum, e_mat)
        x = x + matmul_reference(att, packed["wproj"][i]) * packed["sproj"][i] + packed["bproj"][i]

        u2 = _ln_rows(x, ln[2:3], ln[3:4])
        hid = F.gelu(matmul_reference(u2, packed["w1"][i]) * packed["s1"][i] + packed["b1"][i],
                     approximate="tanh")
        x = x + matmul_reference(hid, packed["w2"][i]) * packed["s2"][i] + packed["b2"][i]
    return x, torch.stack(kqs), torch.stack(vqs), torch.stack(ksns), torch.stack(vsns)


@torch.no_grad()
def decode_block_reference(x: torch.Tensor, packed: tp.Mapping[str, torch.Tensor], kv: KV,
                           index, *, nh: int, pad=None):
    """Plain version of :func:`decode_block`.

    Legacy layout (rings (L, T, D), ``x`` (1, D), scalar ``index``) returns
    ``(y (1, D), kq (L, 1, D), vq, ksn (L, 1, 1), vsn)``. Batched layout (rings
    (L, B, T, D), ``x`` (B, D), ``index`` (B,)) runs the single-stream math once
    per stream and returns ``(y (B, D), kq (L, B, D), vq, ksn (L, B, 1), vsn)``."""
    x = x.to(torch.float32)
    if kv["k"].dim() == 3:
        return _reference_single(x, packed, kv, torch.as_tensor(index, device=x.device), nh, pad)
    batch = x.shape[0]
    idx = _index_vector(index, batch, x.device)
    padv = None if pad is None else _index_vector(pad, batch, x.device)
    outs = []
    for b in range(batch):
        kvb = {k: v[:, b] for k, v in kv.items()}
        outs.append(_reference_single(x[b:b + 1], packed, kvb, idx[b], nh,
                                      None if padv is None else padv[b]))
    ys, kqs, vqs, ksns, vsns = zip(*outs)
    return (torch.cat(ys, dim=0), torch.cat(kqs, dim=1), torch.cat(vqs, dim=1),
            torch.cat(ksns, dim=1), torch.cat(vsns, dim=1))


# ---------------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------------
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"decode_stack": [_P, _P, _I, _I, _P, _P]}


def _lib_decode():
    return _lib.load("decode_kernels", _SIGNATURES)


# the four products of a block: (name, K, N) of a (D, H) model
def _products(d: int, h: int) -> tp.Tuple[tp.Tuple[str, int, int], ...]:
    return (("qkv", d, 3 * d), ("proj", d, d), ("fc", d, h), ("out", h, d))


def stage_plan(k: int, n: int, itemsize: int) -> tp.Tuple[int, int]:
    """``(twb, br)`` of one product of K8: column tiles of ``twb`` bytes (16 to
    256) and TMA boxes of ``br`` rows over each rank's K / 4 rows. The tile
    that makes a stage's critical path shortest when the tiles are dealt to 32
    clusters: the most tiles a cluster takes times the tile's width plus a
    fixed cost; on a tie the wider tile; a tile's rows must fit the ring (8
    boxes). Depends on the matrix alone, so a stream's sums do not depend on
    its companions."""
    row = n * itemsize
    best, best_cost = 0, None
    for twb in (256, 128, 64, 32, 16):
        if k // CLUSTER // box_rows(k // CLUSTER, twb) > _SLOTS:
            continue
        tiles = -(-row // twb)
        cost = -(-tiles // _PLAN_CLUSTERS) * (twb + _TILE_COST)
        if best_cost is None or cost < best_cost:
            best, best_cost = twb, cost
    return best, box_rows(k // CLUSTER, best)


def weight_boxes(n_layer: int, d: int, h: int, itemsize: int, clusters: int, cluster: int,
                 rank: int) -> tp.List[tp.Tuple[int, int, int, int, int, int]]:
    """The weight boxes one CTA of K8 reads over a launch, in the order its
    ring asks TMA for them: ``(layer, product, first byte of the row, first row
    of the product's matrix, bytes, rows)``. Block l's product p has its column
    tiles dealt to the clusters round-robin, continuing from the launch's
    previous product; a cluster's rank takes rows rank * K / 4 .. of each of its
    tiles, in boxes. The same walk as the kernel's ``Cursor``."""
    plans = [stage_plan(k, n, itemsize) for _, k, n in _products(d, h)]
    tiles = [-(-n * itemsize // twb) for (_, _, n), (twb, _) in zip(_products(d, h), plans)]
    per_layer = sum(tiles)
    out = []
    for lay in range(n_layer):
        for p, (_, k, _) in enumerate(_products(d, h)):
            twb, br = plans[p]
            base = (lay * per_layer + sum(tiles[:p])) % clusters
            kc = k // CLUSTER
            for t in range((cluster - base) % clusters, tiles[p], clusters):
                for j in range(kc // br):
                    out.append((lay, p, t * twb, rank * kc + j * br, twb, br))
    return out


def barriers(n_layer: int) -> int:
    """Grid-wide barriers of one launch of K8: five stages a block (qkv,
    attention, proj, fc, out), none after the last. (Cluster barriers, one a
    column tile and one or two a pass of the attention, stay inside a cluster.)"""
    return 5 * n_layer - 1


def _check(t: torch.Tensor, name: str, shape: tp.Tuple[int, ...], dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    if tuple(t.shape) != shape or t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}"
                         f"{'' if t.is_contiguous() else ' (not contiguous)'}")
    return t


def decode_block(x: torch.Tensor, packed: tp.Mapping[str, torch.Tensor], kv: KV, index, *,
                 nh: int, pad=None, stamps: tp.Optional[torch.Tensor] = None):
    """K8. One decode step of B (<= 8) independent streams in one launch.

    ``x`` (B, D) f32 activations after the embedding, a row a stream; ``packed``
    from :func:`pack_core_params` (int8 or bf16 store); ``kv`` from
    :func:`init_mega_kv` / :func:`cache_to_mega`: legacy (L, T, D) for one
    stream or (L, B, T, D) rings, int8 or bf16; ``index`` scalar or (B,): each
    stream's position (ring rows below it are attended); ``pad`` masks each
    stream's first ``pad[b]`` ring rows (left-padded prompts). ``index`` and
    ``pad`` may be device tensors: they are read on the device only.

    Returns ``(y (B, D) f32, kq (L, B, D), vq, ksn (L, B, 1) f32, vsn)``; the
    caller writes the fresh rows into the rings (:func:`mega_update_kv`).

    ``stamps`` (a measurement aid, CUDA only): an int64 tensor of at least
    ``L * 10 * grid_blocks() + 2`` entries that the kernel fills with every
    CTA's SM cycle count at the start and the end of its work in each of a
    block's five stages ((L, 5, 2, grid)), then CTA 0's clock in ns at its
    start and end; a build with ``-DK8_PROBE`` also stamps 7 phases inside each
    stage after them ((L, 5, 8, grid); ``tools/torch_k8_stages.py [--phases]``
    reads them)."""
    if x.device.type == "cpu":
        return decode_block_reference(x, packed, kv, index, nh=nh, pad=pad)
    if not x.is_cuda:
        raise ValueError(f"x: expected a CUDA tensor, got {x.device}")
    if x.requires_grad:
        raise NotImplementedError("decode_block has no backward")
    dev = x.device
    batch = x.shape[0]
    k = kv["k"]
    if k.dim() == 3 and batch != 1:
        raise ValueError("legacy (L, T, D) rings carry exactly one stream")
    n_layer, t, d = k.shape[0], k.shape[-2], k.shape[-1]
    h = packed["w1"].shape[2]
    if not 1 <= batch <= MAX_STREAMS:
        raise ValueError(f"decode_block takes 1..{MAX_STREAMS} streams, got {batch}")
    if d != 64 * nh or d % 128 or d > 2048 or h % 128 or h > 4 * 1280:
        raise ValueError(f"decode_block takes heads of 64 features, D a multiple of 128 up to "
                         f"2048 and H a multiple of 128 up to 5120, got D={d}, {nh} heads, H={h}")
    wdt, kvdt = packed["wqkv"].dtype, k.dtype
    if wdt not in (torch.int8, torch.bfloat16) or kvdt not in (torch.int8, torch.bfloat16):
        raise TypeError(f"decode_block takes int8 or bfloat16 weights and rings, got {wdt}, {kvdt}")
    ring = (n_layer, batch, t, d)
    shapes = {"wqkv": (d, 3 * d), "wproj": (d, d), "w1": (d, h), "w2": (h, d)}
    f32 = torch.float32
    for name, (kk, nn) in shapes.items():
        _check(packed[name], name, (n_layer, kk, nn), wdt, dev)
        for pre in "sb":
            key = pre + {"wqkv": "qkv", "wproj": "proj", "w1": "1", "w2": "2"}[name]
            _check(packed[key], key, (n_layer, 1, nn), f32, dev)
    _check(packed["ln"], "ln", (n_layer, 4, d), f32, dev)
    for name in ("k", "v"):
        _check(kv[name].reshape(ring) if k.dim() == 3 else kv[name], name, ring, kvdt, dev)
        _check(kv[name + "s"].reshape(ring[:-1] + (1,)) if k.dim() == 3 else kv[name + "s"],
               name + "s", ring[:-1] + (1,), f32, dev)
    idx = _index_vector(index, batch, dev).to(torch.int32).contiguous()
    padv = (torch.zeros(batch, dtype=torch.int32, device=dev) if pad is None
            else _index_vector(pad, batch, dev).to(torch.int32).contiguous())

    y = x.to(f32).reshape(batch, d).clone()       # the residual stream, updated in place
    kq = torch.empty((n_layer, batch, d), dtype=kvdt, device=dev)
    vq = torch.empty_like(kq)
    ksn = torch.empty((n_layer, batch, 1), dtype=f32, device=dev)
    vsn = torch.empty_like(ksn)
    size = packed["wqkv"].element_size()
    plans = [stage_plan(kk, nn, size) for _, kk, nn in _products(d, h)]
    work = _scratch("k8_work", dev, batch * (4 * d + h), f32)
    qkv, att, hid = work[:batch * (4 * d + h)].split([batch * 3 * d, batch * d, batch * h])
    sync = _scratch("k8_sync", dev, 2, torch.int32)
    tensors = [y, packed["wqkv"], packed["wproj"], packed["w1"], packed["w2"],
               packed["sqkv"], packed["bqkv"], packed["sproj"], packed["bproj"],
               packed["s1"], packed["b1"], packed["s2"], packed["b2"], packed["ln"],
               kv["k"], kv["v"], kv["ks"], kv["vs"], idx, padv, kq, vq, ksn, vsn,
               qkv, att, hid, sync]
    if stamps is not None:
        need = n_layer * 10 * grid_blocks(wdt, kvdt, batch) + 2
        if (stamps.dtype != torch.int64 or stamps.device != dev or stamps.dim() != 1
                or stamps.numel() < need or not stamps.is_contiguous()):
            raise ValueError(f"stamps: expected a contiguous int64 vector of at least {need} "
                             f"entries on {dev}")
    ptrs = (ctypes.c_void_p * (len(tensors) + 1))(
        *[a.data_ptr() for a in tensors], None if stamps is None else stamps.data_ptr())
    dims = (ctypes.c_int * 14)(n_layer, batch, t, d, h, nh, *[twb for twb, _ in plans],
                               *[br for _, br in plans])
    _lib.check(_lib_decode().decode_stack(
        ptrs, dims, int(wdt == torch.bfloat16), int(kvdt == torch.bfloat16),
        _lib.torch_stream(), None), "decode_block")
    decode_block.launches += 1
    return y, kq, vq, ksn, vsn


decode_block.launches = 0


def grid_blocks(weights: torch.dtype = torch.int8, rings: torch.dtype = torch.int8,
                streams: int = 1) -> int:
    """CTAs of the persistent grid a launch with these types takes on the
    current CUDA device: one an SM, in as many 4-CTA clusters as can be
    resident at once (the same for every geometry K8 takes)."""
    out = ctypes.c_int(0)
    dims = (ctypes.c_int * 14)(1, streams, 256, 128, 512, 2, 16, 16, 16, 16, 32, 32, 32, 32)
    _lib.check(_lib_decode().decode_stack(
        None, dims, int(weights == torch.bfloat16), int(rings == torch.bfloat16), None,
        ctypes.byref(out)), "decode_block (grid query)")
    return out.value
