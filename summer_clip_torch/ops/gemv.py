"""Weight-streaming products for KV-cached decode: plain versions + CUDA kernels.

Counterpart of ``summer_clip_tpu/ops/gemv.py``. Single-stream decode multiplies
a handful of activation rows against every weight matrix per token, so the
stored bytes of the weights are all the work there is; an int8 tree is read as
stored and widened in registers.

- :func:`matmul_reference` -- plain version of K7: ``(x.bf16 @ w.bf16, f32
  sums) * scale``, the scale applied after the sum, per output column.
- :func:`streamed_qmatmul` -- K7, CUDA source ``csrc/gemv_kernels.cu``
  (``cluster_qmatmul_{i8,bf16,f32}``); replaces the TPU kernel
  ``streamed_qmatmul`` (ops/gemv.py:80). :func:`k7_plan` picks its column
  tile, K split (a thread-block cluster) and TMA box from the matrix alone.
- :func:`qdot` -- the dense contraction of ``models/gpt2.QDense`` against a
  plain or int8 leaf, with the JAX package's routing rule: at most 8 rows in
  all and a tile-legal matrix go to K7, everything else runs the same math as
  one ``torch.matmul``.
- :func:`fused_qmlp_reference`, :func:`fused_qmlp` -- K10, the int8 MLP pair
  ``gelu_tanh(x @ w1 * s1 + b1) @ w2 * s2 + b2`` in one launch
  (``fused_qmlp_i8``); replaces the TPU kernel ``fused_qmlp`` (ops/gemv.py:186).
  :func:`k10_plan` picks its hidden chunks, K split (a thread-block cluster) and
  TMA boxes from (D, H) alone. :func:`qmlp` dispatches to it under
  ``SUMMER_CLIP_FUSED_MLP=1``, as the JAX package does.
- :func:`gather_rows` -- embedding rows straight off a plain or int8 table.

An int8 leaf is a :class:`QLeaf`: a small module holding ``q`` (int8) and
``scale`` (f32); :func:`is_qleaf` is true to it and to nothing else.

On a CPU tensor the wrappers run their plain version; on a CUDA tensor they
launch the kernel or raise. The plain f32-out product is written as a float32
``torch.matmul`` of the bf16-rounded operands (a bf16 ``torch.matmul`` would
round its result to bf16): every product of a bf16 and an int8 or bf16 value
is exact in f32, so only the order of the f32 sums differs from the kernel.
It needs TF32 off (``torch.backends.cuda.matmul.allow_tf32``, PyTorch's
default).
"""

from __future__ import annotations

import ctypes
import functools
import os
import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from summer_clip_torch.ops import _lib

__all__ = ["QLeaf", "is_qleaf", "matmul_reference", "streamed_qmatmul", "qdot", "gather_rows",
           "fused_qmlp", "fused_qmlp_reference", "qmlp", "fused_mlp_legal", "k10_plan", "K10Plan",
           "MAX_ROWS"]

MAX_ROWS = 8          # rows a decode-shaped call may have
_BUDGET = 8 * 1024 * 1024   # the JAX package's block budget: part of the routing rule only
# K7's plan: CTAs a launch aims at (one an H100 SM), the K splits a cluster may
# take, the fewest rows of K a split keeps, the most bytes a TMA box holds
_K7_CTAS = 132
_K7_SPLITS = (1, 2, 4, 8)
_K7_MIN_ROWS = 64
_BOX_BYTES = 16384
# K10's plan: the most CTAs a launch takes (one an SM, as many as an H100 holds
# at once in clusters: 120 in K8's clusters of 4), the hidden units a cluster
# may own, output columns a ticket covers, shared memory a CTA may take
_K10_CTAS = 120
_K10_HC = (256, 128, 64, 32, 16)
_K10_GROUP = 16
_SMEM_LIMIT = 232448
# Programmatic dependent launch of K7 and K10: their weight boxes are asked for
# before the kernel before has ended. Off, each launch waits for the last.
PDL = True

_P, _I = ctypes.c_void_p, ctypes.c_int
_QMM = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
_SIGNATURES = {
    "cluster_qmatmul_i8": _QMM, "cluster_qmatmul_bf16": _QMM, "cluster_qmatmul_f32": _QMM,
    "fused_qmlp_i8": [_P] * 10 + [_I] * 9 + [_P],
    "fused_qmlp_clusters": [_I] * 8 + [_P],
}
_ENTRY = {torch.int8: "cluster_qmatmul_i8", torch.bfloat16: "cluster_qmatmul_bf16",
          torch.float32: "cluster_qmatmul_f32"}


def _lib_gemv():
    return _lib.load("gemv_kernels", _SIGNATURES)


class QLeaf(nn.Module):
    """An int8 weight leaf: ``q`` (int8) and ``scale`` (f32, broadcastable to
    ``q``: (1, N) per output column, (rows, 1) per table row). Takes a kernel's
    or a table's place on a module, so state dicts carry ``<name>.q`` and
    ``<name>.scale`` -- the JAX package's ``{"q", "scale"}`` leaf, flattened."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        if q.dtype != torch.int8:
            raise TypeError(f"q: expected int8, got {q.dtype}")
        self.register_buffer("q", q)
        self.register_buffer("scale", scale.to(torch.float32))

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return (self.q.to(torch.float32) * self.scale).to(dtype)

    def extra_repr(self) -> str:
        return f"q={tuple(self.q.shape)}, scale={tuple(self.scale.shape)}"


def is_qleaf(x: tp.Any) -> bool:
    return isinstance(x, QLeaf)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def matmul_reference(x: torch.Tensor, w: torch.Tensor,
                     scale: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K7: bf16 operands, f32 sums, f32 scale after the sum.
    ``w`` (K, N) int8/bf16/f32; ``scale`` (1, N) or (N,). f32 out."""
    wf = w.to(torch.float32) if w.dtype == torch.int8 else _round_bf16(w)
    y = torch.matmul(_round_bf16(x), wf)
    if scale is not None:
        y = y * scale.reshape(1, -1).to(torch.float32)
    return y


def _pick_bn(n: int, k: int, itemsize: int) -> int:
    if k * n * itemsize <= _BUDGET:
        return n
    bn = 4096
    while bn > 128 and 2 * k * bn * itemsize > _BUDGET:
        bn //= 2
    return bn if 2 * k * bn * itemsize <= _BUDGET else 0


def _tile_legal(k: int, n: int, itemsize: int) -> bool:
    """The JAX package's rule for what goes to K7, kept so that both packages
    route alike: K on whole sublane tiles of the weight type, N >= 128."""
    sub = {1: 32, 2: 16, 4: 8}[itemsize]
    return k % sub == 0 and n >= 128 and _pick_bn(n, k, itemsize) > 0


_SCRATCH: tp.Dict[tp.Tuple[str, torch.device], torch.Tensor] = {}


def _scratch(kind: str, device: torch.device, numel: int, dtype: torch.dtype) -> torch.Tensor:
    """Per-device workspace (zeros when made), grown on demand and reused by
    every call. The calls on a device must be ordered by one stream (or by a
    CUDA graph captured after a first call has sized the workspace); a kernel
    that keeps counters in it leaves them at zero."""
    buf = _SCRATCH.get((kind, device))
    if buf is None or buf.numel() < numel:
        buf = torch.zeros(max(numel, 1024), dtype=dtype, device=device)
        _SCRATCH[kind, device] = buf
    return buf


def box_rows(kc: int, twb: int) -> int:
    """Rows of a TMA box over a chunk of ``kc`` rows (a multiple of 8): the most
    that divide the chunk, fit a box of 16 KB and TMA's 256-row limit."""
    top = min(256, _BOX_BYTES // twb, kc)
    return max(r for r in range(8, top + 1, 8) if kc % r == 0)


def k7_plan(k: int, n: int, itemsize: int) -> tp.Tuple[int, int, int, int]:
    """K7's work split: ``(twb, split, kc, br)`` -- column tiles of ``twb``
    bytes (128, else 64, else the row's own width when it is narrower), the K
    axis split over a cluster of ``split`` CTAs in chunks of ``kc`` rows, TMA
    boxes of ``br`` rows. The widest tile and the fewest splits that give one
    CTA an SM; else the most CTAs. Every sum's order follows from this plan,
    which depends on the matrix alone, never on the rows of x: a row's result
    does not depend on the rows that ride with it."""
    row = n * itemsize
    best = None
    for twb in (128, 64):
        if twb > 64 and row <= 64:
            continue
        tiles = -(-row // twb)
        for split in _K7_SPLITS:
            if split > 1 and k < _K7_MIN_ROWS * split:
                break
            if tiles * split >= _K7_CTAS:
                best = (tiles * split, twb, split)
                break
            if best is None or tiles * split > best[0]:
                best = (tiles * split, twb, split)
        if best[0] >= _K7_CTAS:
            break
    _, twb, split = best
    while twb > 16 and twb // 2 >= row:      # a row narrower than the tile: the narrowest tile that holds it
        twb //= 2
    kc = -(-k // split)
    kc = -(-kc // 8) * 8
    return twb, split, kc, box_rows(kc, twb)


def _f32_rows(x: torch.Tensor, name: str, cols: int) -> torch.Tensor:
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dim() != 2 or x.shape[1] != cols or not 1 <= x.shape[0] <= MAX_ROWS:
        raise ValueError(f"{name}: expected (1..{MAX_ROWS}, {cols}), got {tuple(x.shape)}")
    if x.requires_grad:
        raise NotImplementedError("the gemv kernels have no backward")
    return x.to(torch.float32).contiguous()


def _f32_vector(v: torch.Tensor, name: str, n: int, device: torch.device) -> torch.Tensor:
    if v.numel() != n or v.device != device:
        raise ValueError(f"{name}: expected {n} values on {device}, got {tuple(v.shape)} on {v.device}")
    return v.reshape(n).to(torch.float32).contiguous()


def streamed_qmatmul(x: torch.Tensor, w: torch.Tensor,
                     scale: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7. ``x (R <= 8, K) @ w (K, N) -> (R, N) f32``, reading ``w`` as stored:
    int8 with ``scale`` (1, N)/(N,) applied after the sum, or bf16/f32 (scale
    optional). A ``w`` that is not row-major contiguous is copied first.

    With :data:`PDL` the launch may start before the kernel launched just
    before it on the stream has ended: it asks for ``w``'s first boxes then,
    and reads ``x`` and ``scale`` only after that kernel's writes are visible.
    So ``w`` must not be written by that kernel (stored weights never are; a
    ``w`` this wrapper copies is launched without it)."""
    if x.device.type == "cpu":
        return matmul_reference(x, w, scale)
    k, n = w.shape
    xr = _f32_rows(x, "x", k)
    if w.device != x.device or w.dtype not in _ENTRY:
        raise TypeError(f"w: expected int8, bfloat16 or float32 on {x.device}, "
                        f"got {w.dtype} on {w.device}")
    copied = not w.is_contiguous()
    w = w.contiguous()
    s = None if scale is None else _f32_vector(scale, "scale", n, x.device)
    rows = xr.shape[0]
    twb, split, kc, br = k7_plan(k, n, w.element_size())
    out = torch.empty((rows, n), dtype=torch.float32, device=x.device)
    _lib.check(getattr(_lib_gemv(), _ENTRY[w.dtype])(
        xr.data_ptr(), w.data_ptr(), 0 if s is None else s.data_ptr(), out.data_ptr(), rows, k, n,
        twb, split, kc, br, int(PDL and not copied), _lib.torch_stream()), "streamed_qmatmul")
    streamed_qmatmul.launches += 1
    return out


streamed_qmatmul.launches = 0


def _gemv_enabled() -> bool:
    return os.environ.get("SUMMER_CLIP_GEMV", "1") != "0"


def qdot(x: torch.Tensor, leaf: tp.Union[torch.Tensor, QLeaf], dtype: torch.dtype) -> torch.Tensor:
    """``x (..., K)`` against a plain (K, N) tensor or an int8 :class:`QLeaf`
    with per-column scales. Decode-shaped calls (at most 8 rows in all, a
    tile-legal matrix) go through K7; every other call on an int8 leaf runs
    the same math (:func:`matmul_reference`), and a wide call on a plain leaf
    is a product in ``dtype``. ``SUMMER_CLIP_GEMV=0`` sends every call the wide
    way, as in the JAX package."""
    q, scale = (leaf.q, leaf.scale) if is_qleaf(leaf) else (leaf, None)
    k, n = q.shape
    lead = x.shape[:-1]
    rows = 1
    for d in lead:
        rows *= d
    if rows <= MAX_ROWS and _tile_legal(k, n, q.element_size()) and _gemv_enabled():
        return streamed_qmatmul(x.reshape(rows, k), q, scale).reshape(*lead, n).to(dtype)
    if scale is not None:
        return matmul_reference(x.reshape(rows, k), q, scale).reshape(*lead, n).to(dtype)
    return torch.matmul(x.to(dtype), q.to(dtype))


def _pick_bh(d: int, h: int, itemsize: int) -> int:
    best = 0
    for bh in range(128, h + 1, 128):
        if h % bh == 0 and 4 * d * bh * itemsize <= _BUDGET:
            best = bh
    return best


def fused_mlp_legal(d: int, h: int, itemsize: int) -> bool:
    """What :func:`qmlp` sends to K10: the JAX package's rule (D a multiple of
    128, a hidden chunk of a multiple of 128 that divides H). :func:`k10_plan`
    has a plan for each such shape."""
    return d % 128 == 0 and _pick_bh(d, h, itemsize) > 0


class K10Plan(tp.NamedTuple):
    """K10's work split. Cluster c owns hidden units ``[c hc, (c + 1) hc)``;
    its ``split`` CTAs (ranks) split the first product's K and the second
    product's columns: rank r owns rows ``[r kc, (r + 1) kc)`` of w1 and the
    same columns of w2 and of the output. w1 arrives in boxes of ``br1`` rows
    of ``hc`` bytes; w2 in column tiles of ``twb2`` bytes, boxes of ``br2``
    rows."""
    hc: int
    split: int
    kc: int
    br1: int
    twb2: int
    br2: int
    clusters: int

    @property
    def ctas(self) -> int:
        return self.clusters * self.split


def k10_smem(plan: K10Plan, rows: int = MAX_ROWS) -> int:
    """Shared memory of a K10 CTA (bytes) for ``rows`` rows of x, as the kernel
    lays it out (``mlp_layout`` in ``csrc/gemv_kernels.cu``), for the kernel's
    template of that many rows."""
    r = 1 if rows == 1 else 2 if rows == 2 else 4 if rows <= 4 else 8

    def up(v):
        return -(-v // 128) * 128

    nb1, nt2, nb2 = plan.kc // plan.br1, plan.kc // plan.twb2, plan.hc // plan.br2
    staged = nb1 * up(plan.br1 * plan.hc) + 4 * r * plan.kc
    red = 4 * 8 * r * max(plan.hc, plan.twb2)
    rest = nt2 * nb2 * up(plan.br2 * plan.twb2) + 4 * (plan.split + 1) * r * plan.hc
    # the final sums: running sums and one cluster's box of partials a column group
    sums = up(4 * r * plan.kc) + plan.kc // _K10_GROUP * up(4 * _K10_GROUP * r)
    return (up(max(staged, red, sums - rest)) + rest + 8 * ((nb1 + nt2 * nb2 + 2) // 2 * 2)
            + -(-4 * (plan.kc // _K10_GROUP + 1) // 16) * 16 + 8 * plan.kc)


@functools.lru_cache(maxsize=None)
def k10_plan(d: int, h: int) -> K10Plan:
    """K10's plan for w1 (d, h) and w2 (h, d), from the geometry alone (kept per
    shape: a decoded token calls K10 once a block). Of the
    plans whose CTAs fit shared memory at 8 rows: the most CTAs up to
    ``_K10_CTAS`` (one wave, one an SM: every weight byte asked for at launch),
    else the fewest; then the widest hidden chunk (fewer partials to add), then
    the widest column tile of w2. Every sum's order follows from this plan,
    never from the rows of x: a row's result does not depend on the rows that
    ride with it. Raises ValueError for a shape no plan takes."""
    best, best_key = None, None
    for hc in _K10_HC:
        if h % hc:
            continue
        for split in range(1, 9):
            if d % split or (d // split) % _K10_GROUP:
                continue
            kc = d // split
            twb2 = 256
            while kc % twb2:
                twb2 //= 2
            plan = K10Plan(hc, split, kc, box_rows(kc, hc), twb2, box_rows(hc, twb2), h // hc)
            if k10_smem(plan) > _SMEM_LIMIT:
                continue
            fits = plan.ctas <= _K10_CTAS
            key = (fits, plan.ctas if fits else -plan.ctas, hc, twb2)
            if best_key is None or key > best_key:
                best, best_key = plan, key
    if best is None:
        raise ValueError(f"fused_qmlp: no plan takes D={d} H={h} (D and H multiples of "
                         f"{_K10_GROUP}, a CTA's share within {_SMEM_LIMIT} bytes of shared memory)")
    return best


def fused_qmlp_reference(x, w1, s1, b1, w2, s2, b2) -> torch.Tensor:
    """Plain version of K10: bf16 operands, f32 sums, f32 scale after each
    sum, tanh-GELU on the f32 hidden, which is not rounded to a model type
    between the two products."""
    t = matmul_reference(x, w1, s1) + b1.reshape(1, -1).to(torch.float32)
    hact = F.gelu(t, approximate="tanh")
    return matmul_reference(hact, w2, s2) + b2.reshape(1, -1).to(torch.float32)


def fused_qmlp(x: torch.Tensor, w1: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, s2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """K10. ``gelu_tanh(x @ w1 * s1 + b1) @ w2 * s2 + b2`` for x (R <= 8, D),
    w1 (D, H) and w2 (H, D) int8, in one launch (:func:`k10_plan`); the hidden
    never reaches device memory. (R, D) f32 out.

    With :data:`PDL` the launch asks for every weight byte before the kernel
    launched just before it on the stream has ended, and reads x, the scales
    and the biases after. So w1 and w2 must not be written by that kernel
    (stored weights never are; weights this wrapper copies are launched
    without it)."""
    if x.device.type == "cpu":
        return fused_qmlp_reference(x, w1, s1, b1, w2, s2, b2)
    d, h = w1.shape
    xr = _f32_rows(x, "x", d)
    for name, w, shape in (("w1", w1, (d, h)), ("w2", w2, (h, d))):
        if w.dtype != torch.int8 or w.device != x.device or tuple(w.shape) != shape:
            raise TypeError(f"{name}: expected int8 {shape} on {x.device}, got {w.dtype} "
                            f"{tuple(w.shape)} on {w.device}")
    plan = k10_plan(d, h)
    copied = not (w1.is_contiguous() and w2.is_contiguous())
    w1, w2 = w1.contiguous(), w2.contiguous()
    s1v, b1v = _f32_vector(s1, "s1", h, x.device), _f32_vector(b1, "b1", h, x.device)
    s2v, b2v = _f32_vector(s2, "s2", d, x.device), _f32_vector(b2, "b2", d, x.device)
    # the kernel reads x, s2 and b2 16 bytes at a time
    xr, s2v, b2v = (t.clone() if t.data_ptr() % 16 else t for t in (xr, s2v, b2v))
    rows = xr.shape[0]
    out = torch.empty((rows, d), dtype=torch.float32, device=x.device)
    part = _scratch("k10_partials", x.device, plan.clusters * rows * d, torch.float32)
    tickets = _scratch("k10_tickets", x.device, d // _K10_GROUP, torch.int32)
    _lib.check(_lib_gemv().fused_qmlp_i8(
        xr.data_ptr(), w1.data_ptr(), s1v.data_ptr(), b1v.data_ptr(), w2.data_ptr(),
        s2v.data_ptr(), b2v.data_ptr(), out.data_ptr(), part.data_ptr(), tickets.data_ptr(), rows,
        d, h, plan.hc, plan.split, plan.br1, plan.twb2, plan.br2, int(PDL and not copied),
        _lib.torch_stream()), "fused_qmlp")
    fused_qmlp.launches += 1
    return out


fused_qmlp.launches = 0


def qmlp(x: torch.Tensor, leaf1, bias1: torch.Tensor, leaf2, bias2: torch.Tensor,
         dtype: torch.dtype) -> tp.Optional[torch.Tensor]:
    """Fused-MLP dispatch: K10 when both leaves are int8, the call is
    decode-shaped and legal, and ``SUMMER_CLIP_FUSED_MLP=1`` opts in; ``None``
    otherwise, and the caller runs the unfused pair. Off by default, as in the
    JAX package, so that both packages route alike."""
    if not (is_qleaf(leaf1) and is_qleaf(leaf2)):
        return None
    if os.environ.get("SUMMER_CLIP_FUSED_MLP", "0") != "1" or not _gemv_enabled():
        return None
    d, h = leaf1.q.shape
    if tuple(leaf2.q.shape) != (h, d) or not fused_mlp_legal(d, h, leaf1.q.element_size()):
        return None
    lead = x.shape[:-1]
    rows = 1
    for n in lead:
        rows *= n
    if rows > MAX_ROWS:
        return None
    y = fused_qmlp(x.reshape(rows, d), leaf1.q, leaf1.scale, bias1, leaf2.q, leaf2.scale, bias2)
    return y.reshape(*lead, d).to(dtype)


def gather_rows(leaf: tp.Union[torch.Tensor, QLeaf], ids: torch.Tensor) -> torch.Tensor:
    """Embedding rows off the stored leaf: an int8 table gives one int8 row
    and its scale per id; the table is never widened."""
    ids = ids.long()
    if is_qleaf(leaf):
        return leaf.q[ids].to(torch.float32) * leaf.scale[ids]
    return leaf[ids]
