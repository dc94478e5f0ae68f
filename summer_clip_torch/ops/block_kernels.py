"""Fused transformer-block halves for the CLIP towers (K5, K6).

Counterpart of ``summer_clip_tpu/ops/block_kernels.py``. Each wrapper takes
the OpenAI ``clip.load`` parameter layout (``Linear.weight`` is (out, in);
attention q/k/v ride one ``in_proj_weight`` of shape (3D, D)):

- :func:`fused_ln_attn` -- K5, ``x + out_proj(MHA(LN_f32(x)))``. CUDA source
  ``csrc/block_kernels.cu``: ``ln_rows`` (LayerNorm once a row), then
  ``block_gemm`` (in_proj + bias, a ``wgmma`` GEMM on TMA-staged tiles of 128
  rows), K4's attention device code on q, k and v as views of the fused
  projection (``csrc/attention_kernels.cu``, launched without counting a K4
  launch), then ``block_gemm`` (out_proj + bias + residual); replaces the TPU
  kernel ``fused_ln_attn`` (ops/block_kernels.py:255).
- :func:`fused_ln_mlp` -- K6, ``x + c_proj(QuickGELU(c_fc(LN_f32(x))))``. CUDA
  source ``csrc/block_kernels.cu``: ``ln_rows``, ``block_gemm`` (c_fc + bias,
  QuickGELU), ``block_gemm`` (c_proj + bias + residual); replaces the TPU
  kernel ``fused_ln_mlp`` (ops/block_kernels.py:75). The intermediates pass
  through device memory in the bf16 the JAX kernels round them to, so the
  function and its rounding points are the TPU kernels'. :func:`gemm_tile`
  picks each product's block tile.
- :func:`fused_ln_mlp_chunked` -- K9, the same function at the ViT-L/14 width
  (D = 1024), whose MLP weights the JAX package streams in hidden chunks. CUDA
  source ``csrc/block_kernels.cu`` (``ln_mlp_wide``: wgmma on TMA-staged
  weights, a cluster of two blocks a 64-row tile that share each hidden chunk
  over distributed shared memory; :func:`k9_grid`); replaces the TPU
  kernel ``fused_ln_mlp_chunked`` (ops/block_kernels.py:132). Its plain
  version is :func:`ln_mlp_reference` (the same function up to the order of
  the f32 sums).
- :func:`fused_ln_attn_ad`, :func:`fused_ln_mlp_ad` -- the differentiable
  wrappers: the kernel forward, the plain version recomputed for the backward
  (the JAX package's ``custom_vjp`` pattern, ops/block_kernels.py:322-376).
  :func:`fused_ln_mlp_ad` picks K9 or K6 by :func:`mlp_kernel`, the JAX
  package's ``_mlp_dispatch`` rule.

On a CPU tensor a wrapper runs its plain PyTorch version
(:func:`ln_attn_reference`, :func:`ln_mlp_reference`). On a CUDA tensor it
launches the kernel or raises; it never falls back. The raw kernel wrappers
are forward-only: on the card they refuse inputs that require grad, and every
route that may carry a gradient goes through the ``_ad`` wrappers. The CUDA
kernels take bf16 activations and weights with f32 LayerNorm parameters; what
bounds them on the card is described at the top of the CUDA source. Each
wrapper counts one launch a call (``fused_ln_attn.launches``, ...), however
many CUDA launches its chain makes.
"""

from __future__ import annotations

import ctypes
import functools
import typing as tp

import torch
import torch.nn.functional as F

from summer_clip_torch.ops import _lib
from summer_clip_torch.ops.attention import SHORT_MAX_T
from summer_clip_torch.ops.attention import _launch as _attention_core
from summer_clip_torch.ops.autograd import recompute_backward

__all__ = ["quick_gelu", "ln_f32", "dense", "ln_attn_reference", "ln_mlp_reference",
           "fused_ln_attn", "fused_ln_mlp", "fused_ln_mlp_chunked", "fused_ln_attn_ad",
           "fused_ln_mlp_ad", "mlp_kernel", "fused_attn_ok", "fused_mlp_ok",
           "fused_mlp_chunked_ok", "HEAD_DIM", "MAX_T", "MAX_D", "CHUNKED_MLP_WIDTHS",
           "FUSED_MLP_MAX_WEIGHT_BYTES", "k9_grid", "K9_SHARED_BYTES", "gemm_tile",
           "GEMM_ROWS", "GEMM_DEPTH", "GEMM_TILES"]

HEAD_DIM = 64      # the CUDA attention kernel's head width
MAX_T = SHORT_MAX_T   # K5's attention is K4's device code: K and V of a head resident
MAX_D = 1024       # widest row the kernels' LayerNorm holds in registers
CHUNKED_MLP_WIDTHS = (1024,)   # K9: a block holds half of the output columns
# K9's tiling (csrc/block_kernels.cu, namespace k9): a cluster of two blocks a
# 64-row tile, one half of the output columns each; the hidden in chunks of
# 128 (each block makes 64 and sends them to its partner); a ring of five 16 KB
# weight tiles beside LN(x) (64 x 1024 bf16) and the chunk (64 x 136 bf16)
K9_ROWS, K9_CLUSTER, K9_CHUNK = 64, 2, 128
K9_SHARED_BYTES = 1024 + 64 * 1024 * 2 + 5 * 16384 + 64 * (128 + 8) * 2 + 8 * 7
# The JAX package's _mlp_dispatch threshold: MLP weights above it (ViT-L/14:
# 16.8 MB in bf16) go to the hidden-chunked kernel.
FUSED_MLP_MAX_WEIGHT_BYTES = 12 * 1024 * 1024
# K5's and K6's products (csrc/block_kernels.cu, block_gemm): a block owns
# GEMM_ROWS rows x one of GEMM_TILES columns (two warpgroups of 64 rows) and
# takes its operands in GEMM_DEPTH-deep stages; one block an SM
GEMM_ROWS, GEMM_DEPTH = 128, 64
GEMM_TILES = (256, 192, 128)
# A block tile's fixed cost (ring fill, epilogue) in 64-deep stages, as
# :func:`gemm_tile` weighs it against the main loop
_TILE_FIXED = 2
_EPILOGUES = {"bias": 0, "gelu": 1, "residual": 2}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ln_rows_bf16": [_P, _P, _P, _P, _I, _I, _F, _P],
    "block_gemm_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "ln_mlp_chunked_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "ln_mlp_wide_smem_bytes": [],
    "ln_mlp_wide_cluster": [],
}


def _lib_block():
    return _lib.load("block_kernels", _SIGNATURES)


def fused_attn_ok(t: int, d: int, num_heads: int) -> bool:
    """What K5 takes. The one gate between the fused attention half and the
    LayerNorm -> in_proj -> short attention (K4) -> out_proj route of a
    residual block; :func:`fused_ln_attn` raises on the same test."""
    return num_heads > 0 and d == num_heads * HEAD_DIM and 0 < t <= MAX_T and d <= MAX_D


def fused_mlp_ok(d: int, hidden: int) -> bool:
    """What K6 takes; the gate between the fused MLP half and the plain
    c_fc -> QuickGELU -> c_proj products. :func:`fused_ln_mlp` raises on it."""
    return 0 < d <= MAX_D and d % 64 == 0 and hidden > 0 and hidden % 64 == 0


def fused_mlp_chunked_ok(d: int, hidden: int) -> bool:
    """What K9 takes; :func:`fused_ln_mlp_chunked` raises on it."""
    return d in CHUNKED_MLP_WIDTHS and hidden % 64 == 0


def k9_grid(rows: int, hidden: int) -> tp.Tuple[int, int]:
    """K9's launch: (blocks, hidden chunks a block walks) for ``rows`` = B * T.
    Rows past the last whole tile are masked; a hidden of 64 mod 128 ends on a
    half chunk whose missing columns arrive as zeros."""
    return K9_CLUSTER * -(-rows // K9_ROWS), -(-hidden // K9_CHUNK)


@functools.lru_cache(maxsize=None)
def gemm_tile(m: int, n: int, k: int, sms: int = 132) -> int:
    """The block tile's columns for an (m x k) . (k x n) product on ``sms``
    SMs at one block an SM: the tile of :data:`GEMM_TILES` with the least
    modelled time, the wider one on a tie. The model: waves x a tile's time,
    taken in proportion to the bytes it takes in (its 64-deep stages, plus
    :data:`_TILE_FIXED` stages for the ring's fill and the epilogue, x (128 +
    columns) rows). So a 256-column tile (85 operations a byte) wins unless it
    leaves most of a last wave idle, as the 768-column products do at the
    ViT-B/16 image shape (150 tiles for 132 SMs), where 192 columns make 200
    tiles. On the card the pick is the fastest of the three tiles for every
    product ``tools/torch_block_gemm_tiles.py`` times (PERF.md section 6)."""
    tiles_m, stages = -(-m // GEMM_ROWS), -(-k // GEMM_DEPTH)

    def cost(bn):
        waves = -(-tiles_m * -(-n // bn) // sms)
        return waves * (stages + _TILE_FIXED) * (GEMM_ROWS + bn), -bn

    return min(GEMM_TILES, key=cost)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(1.702 x)`` with the JAX package's rounding: the constant
    and the product in x's dtype, the sigmoid in f32 rounded back."""
    c = torch.tensor(1.702, dtype=x.dtype, device=x.device)
    return x * torch.sigmoid((c * x).float()).to(x.dtype)


def ln_f32(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 with f32 scale and bias, rounded to x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], weight.float(), bias.float(), eps).to(x.dtype)


def dense(z: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # f32-accumulated product rounded to z's dtype, then the bias in that dtype
    return torch.matmul(z, w.to(z.dtype).t()) + b.to(z.dtype)


def ln_attn_reference(x, ln_w, ln_b, in_w, in_b, out_w, out_b, *, num_heads: int,
                      causal: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """Plain version of K5: ``x + out_proj(MHA(q, k, v of LN_f32(x)))``."""
    b, t, d = x.shape
    hd = d // num_heads
    y = ln_f32(x, ln_w, ln_b, eps)
    q, k, v = dense(y, in_w, in_b).split(d, dim=-1)

    def split(z):
        return z.reshape(b, t, num_heads, hd).transpose(1, 2)

    s = torch.matmul(split(q).float(), split(k).float().transpose(-1, -2)) * (1.0 / hd ** 0.5)
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        s = s.masked_fill(~keep, -1e30)
    p = torch.softmax(s, dim=-1).to(x.dtype)
    o = torch.matmul(p, split(v)).transpose(1, 2).reshape(b, t, d)
    return x + dense(o, out_w, out_b)


def ln_mlp_reference(x, ln_w, ln_b, fc_w, fc_b, proj_w, proj_b,
                     eps: float = 1e-5) -> torch.Tensor:
    """Plain version of K6: ``x + c_proj(quick_gelu(c_fc(LN_f32(x))))``."""
    y = ln_f32(x, ln_w, ln_b, eps)
    return x + dense(quick_gelu(dense(y, fc_w, fc_b)), proj_w, proj_b)


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    if t.requires_grad:
        raise NotImplementedError(f"{name} requires grad: the kernel has no backward; "
                                  f"use the _ad wrapper")
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def _ln_rows(lib, x, ln_w, ln_b, eps, stream, out) -> torch.Tensor:
    """out = LN(x) in f32 with f32 scale and bias, rounded to bf16 (``ln_rows``)."""
    _lib.check(lib.ln_rows_bf16(x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), out.data_ptr(),
                                x.numel() // x.shape[-1], x.shape[-1], eps, stream), "ln_rows")
    return out


def _gemm(lib, a, w, bias, epilogue: str, stream, out=None, res=None) -> torch.Tensor:
    """out = epilogue(a . w^T) over a's rows (``block_gemm``): a (..., K), w (N, K)."""
    k, n = a.shape[-1], w.shape[0]
    m = a.numel() // k
    if out is None:
        out = torch.empty((*a.shape[:-1], n), dtype=a.dtype, device=a.device)
    _lib.check(lib.block_gemm_bf16(a.data_ptr(), w.data_ptr(), bias.data_ptr(),
                                   res.data_ptr() if res is not None else None, out.data_ptr(),
                                   m, n, k, _gemm_tile_on(a, n, k), _EPILOGUES[epilogue], stream),
               "block_gemm")
    return out


def _gemm_tile_on(a: torch.Tensor, n: int, k: int) -> int:
    return gemm_tile(a.numel() // k, n, k, _sm_count(a.device.index or 0))


Chain = tp.List[tp.Tuple[str, tp.Callable[[], tp.Any]]]


def _attn_chain(x, ln_w, ln_b, in_w, in_b, out_w, out_b, *, num_heads: int, causal: bool,
                eps: float) -> tp.Tuple[Chain, torch.Tensor]:
    """K5's launches in order, each named, and the tensor the last one
    writes; each launch reads what the ones before it wrote. The wrapper runs
    them; ``chip_smoke.py`` also times them one by one."""
    b, t, d = x.shape
    lib, stream = _lib_block(), _lib.torch_stream()
    y, o, out = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    qkv = x.new_empty((b, t, 3 * d))
    return [
        ("ln_rows", lambda: _ln_rows(lib, x, ln_w, ln_b, eps, stream, y)),
        (f"in_proj (tile {_gemm_tile_on(y, 3 * d, d)})",
         lambda: _gemm(lib, y, in_w, in_b, "bias", stream, qkv)),
        # K4's device code on q, k, v as views of the fused projection (no K4 launch counted)
        ("attention (K4 code)",
         lambda: _attention_core(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], o, b,
                                 num_heads, t, causal)),
        (f"out_proj (tile {_gemm_tile_on(o, d, d)})",
         lambda: _gemm(lib, o, out_w, out_b, "residual", stream, out, res=x)),
    ], out


def _mlp_chain(x, ln_w, ln_b, fc_w, fc_b, proj_w, proj_b, *,
               eps: float) -> tp.Tuple[Chain, torch.Tensor]:
    """K6's launches in order, as :func:`_attn_chain` gives K5's."""
    d, h = x.shape[-1], fc_w.shape[0]
    lib, stream = _lib_block(), _lib.torch_stream()
    y, out = torch.empty_like(x), torch.empty_like(x)
    hidden = x.new_empty((*x.shape[:-1], h))
    return [
        ("ln_rows", lambda: _ln_rows(lib, x, ln_w, ln_b, eps, stream, y)),
        (f"c_fc (tile {_gemm_tile_on(y, h, d)})",
         lambda: _gemm(lib, y, fc_w, fc_b, "gelu", stream, hidden)),
        (f"c_proj (tile {_gemm_tile_on(hidden, d, h)})",
         lambda: _gemm(lib, hidden, proj_w, proj_b, "residual", stream, out, res=x)),
    ], out


def _run(chain: tp.Tuple[Chain, torch.Tensor]) -> torch.Tensor:
    steps, out = chain
    for _, launch in steps:
        launch()
    return out


def fused_ln_attn(x, ln_w, ln_b, in_w, in_b, out_w, out_b, *, num_heads: int,
                  causal: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """K5. x (B, T, D); in_w (3D, D), in_b (3D,); out_w (D, D), out_b (D,)."""
    if x.device.type == "cpu":
        return ln_attn_reference(x, ln_w, ln_b, in_w, in_b, out_w, out_b,
                                 num_heads=num_heads, causal=causal, eps=eps)
    b, t, d = x.shape
    if not fused_attn_ok(t, d, num_heads):
        raise ValueError(f"K5 kernel takes head dim {HEAD_DIM}, 0 < T <= {MAX_T} and "
                         f"D <= {MAX_D}; got T={t}, D={d}, heads={num_heads}")
    bf = torch.bfloat16
    _require(x, "x", bf, (b, t, d))
    _require(ln_w, "ln_w", torch.float32, (d,))
    _require(ln_b, "ln_b", torch.float32, (d,))
    _require(in_w, "in_w", bf, (3 * d, d))
    _require(in_b, "in_b", bf, (3 * d,))
    _require(out_w, "out_w", bf, (d, d))
    _require(out_b, "out_b", bf, (d,))
    out = _run(_attn_chain(x, ln_w, ln_b, in_w, in_b, out_w, out_b, num_heads=num_heads,
                           causal=causal, eps=eps))
    fused_ln_attn.launches += 1
    return out


fused_ln_attn.launches = 0


def _check_mlp(x, ln_w, ln_b, fc_w, fc_b, proj_w, proj_b) -> None:
    b, t, d = x.shape
    h = fc_w.shape[0]
    bf = torch.bfloat16
    _require(x, "x", bf, (b, t, d))
    _require(ln_w, "ln_w", torch.float32, (d,))
    _require(ln_b, "ln_b", torch.float32, (d,))
    _require(fc_w, "fc_w", bf, (h, d))
    _require(fc_b, "fc_b", bf, (h,))
    _require(proj_w, "proj_w", bf, (d, h))
    _require(proj_b, "proj_b", bf, (d,))


def fused_ln_mlp(x, ln_w, ln_b, fc_w, fc_b, proj_w, proj_b, *,
                 eps: float = 1e-5) -> torch.Tensor:
    """K6. x (B, T, D); fc_w (H, D), fc_b (H,); proj_w (D, H), proj_b (D,)."""
    if x.device.type == "cpu":
        return ln_mlp_reference(x, ln_w, ln_b, fc_w, fc_b, proj_w, proj_b, eps=eps)
    d, h = x.shape[-1], fc_w.shape[0]
    if not fused_mlp_ok(d, h):
        raise ValueError(f"K6 kernel takes D % 64 == 0, D <= {MAX_D} and H % 64 == 0; "
                         f"got D={d}, H={h}")
    _check_mlp(x, ln_w, ln_b, fc_w, fc_b, proj_w, proj_b)
    out = _run(_mlp_chain(x, ln_w, ln_b, fc_w, fc_b, proj_w, proj_b, eps=eps))
    fused_ln_mlp.launches += 1
    return out


fused_ln_mlp.launches = 0


def fused_ln_mlp_chunked(x, ln_w, ln_b, fc_w, fc_b, proj_w, proj_b, *,
                         eps: float = 1e-5) -> torch.Tensor:
    """K9. K6's function at D = 1024: x (B, T, D); fc_w (H, D), fc_b (H,);
    proj_w (D, H), proj_b (D,). Every output is summed in f32 over the hidden
    chunks in one fixed order, so two runs give the same bits."""
    if x.device.type == "cpu":
        return ln_mlp_reference(x, ln_w, ln_b, fc_w, fc_b, proj_w, proj_b, eps=eps)
    d, h = x.shape[-1], fc_w.shape[0]
    if not fused_mlp_chunked_ok(d, h):
        raise ValueError(f"K9 kernel takes D in {CHUNKED_MLP_WIDTHS} and H % 64 == 0; "
                         f"got D={d}, H={h}")
    _check_mlp(x, ln_w, ln_b, fc_w, fc_b, proj_w, proj_b)
    out = torch.empty_like(x)
    _lib.check(_lib_block().ln_mlp_chunked_bf16(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), fc_w.data_ptr(), fc_b.data_ptr(),
        proj_w.data_ptr(), proj_b.data_ptr(), out.data_ptr(), x.numel() // d, d, h, eps,
        _lib.torch_stream()), "ln_mlp_chunked_bf16")
    fused_ln_mlp_chunked.launches += 1
    return out


fused_ln_mlp_chunked.launches = 0


def mlp_kernel(x: torch.Tensor, fc_w: torch.Tensor):
    """The JAX package's ``_mlp_dispatch``: K9 where the two MLP weights in
    x's dtype exceed :data:`FUSED_MLP_MAX_WEIGHT_BYTES`, else K6."""
    weight_bytes = 2 * fc_w.shape[0] * fc_w.shape[1] * x.element_size()
    return fused_ln_mlp_chunked if weight_bytes > FUSED_MLP_MAX_WEIGHT_BYTES else fused_ln_mlp


def fused_ln_attn_ad(x, ln_w, ln_b, in_w, in_b, out_w, out_b, *, num_heads: int,
                     causal: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """Differentiable K5: the kernel forward, :func:`ln_attn_reference`
    recomputed for the backward. The plain version itself on the CPU."""
    kw = dict(num_heads=num_heads, causal=causal, eps=eps)
    args = (x, ln_w, ln_b, in_w, in_b, out_w, out_b)
    if x.device.type == "cpu":
        return fused_ln_attn(*args, **kw)
    return recompute_backward(fused_ln_attn, ln_attn_reference, args, kw)


def fused_ln_mlp_ad(x, ln_w, ln_b, fc_w, fc_b, proj_w, proj_b, *,
                    eps: float = 1e-5) -> torch.Tensor:
    """Differentiable K9 or K6 (:func:`mlp_kernel`): the kernel forward,
    :func:`ln_mlp_reference` recomputed for the backward. The plain version
    itself on the CPU."""
    kern = mlp_kernel(x, fc_w)
    args = (x, ln_w, ln_b, fc_w, fc_b, proj_w, proj_b)
    if x.device.type == "cpu":
        return kern(*args, eps=eps)
    return recompute_backward(kern, ln_mlp_reference, args, {"eps": eps})
