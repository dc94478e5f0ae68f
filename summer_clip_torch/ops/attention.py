"""Attention ops: plain PyTorch reference + hand-written CUDA kernels.

Counterpart of ``summer_clip_tpu/ops/attention.py``:

- :func:`mha_reference` -- scaled dot-product attention in plain PyTorch with
  the JAX package's rounding (f32 scores and softmax, probabilities rounded to
  the value dtype before the PV product). The oracle and the CPU path.
- :func:`short_attention_packed` -- K4, exact-softmax attention on the packed
  (B, T, H * hd) layout. CUDA source ``csrc/attention_kernels.cu``
  (``short_attention_bf16``: 64-query warpgroup tiles on ``wgmma``, K/V of a
  head resident in shared memory by TMA, two passes over the keys);
  replaces the TPU kernel ``short_attention_packed`` (ops/attention.py:248).
- :func:`short_attention` -- K12, the same device code on (BH, T, hd);
  replaces the TPU kernel ``short_attention`` (ops/attention.py:195).
- :func:`flash_attention` -- K11, online-softmax attention on (BH, T, hd) with
  ``tq != tk`` and a causal mask shifted by ``q_offset``
  (``flash_attention_bf16``: the same warpgroup template over a TMA ring of
  K/V tiles; ``flash_attention_f32``: register micro-tiles on the CUDA cores);
  replaces the TPU kernel ``flash_attention`` (ops/attention.py:87). Its plain
  version is :func:`flash_attention_reference`.
- :func:`short_attention_packed_ad`, :func:`short_attention_ad`,
  :func:`flash_attention_ad` -- the differentiable wrappers of K4, K12 and
  K11: the kernel forward, the plain version recomputed for the backward
  (the JAX package's ``custom_vjp`` pairs, ``ops/attention.py:302-401``).
- :func:`multi_head_attention` -- split heads, attend, merge, with the JAX
  package's selection rule (``ops/attention.py:404-452``): K4 or K11 through
  their ``_ad`` wrappers, or the plain route (:func:`mha_reference` with mask,
  ``causal`` and ``q_offset`` folded into one bias) for every call the JAX
  package leaves to XLA.

On a CPU tensor the kernel wrappers run their plain version; on a CUDA tensor
they launch the kernel or raise, never the plain version. K4 and K12 take
T <= :data:`SHORT_MAX_T`; all three take bf16 (tensor cores) or f32 (true f32
products: ``short_attention_f32`` / ``flash_attention_f32`` share their device
code) and head dim 64. The raw kernels are forward-only and refuse inputs
that require grad on CUDA; a gradient goes through the ``_ad`` wrappers.
:data:`FLASH_ENABLED`, :data:`FLASH_MIN_KV` and :data:`SHORT_FUSED_ENABLED`
are the JAX package's switches with its defaults, so both packages route alike.
"""

from __future__ import annotations

import ctypes
import typing as tp

import torch

from summer_clip_torch.ops import _lib
from summer_clip_torch.ops.autograd import recompute_backward

__all__ = ["mha_reference", "short_attention", "short_attention_packed",
           "short_attention_packed_reference", "short_attention_reference", "flash_attention",
           "flash_attention_reference", "short_attention_packed_ad", "short_attention_ad",
           "flash_attention_ad", "multi_head_attention", "attention_route", "SHORT_MAX_T",
           "HEAD_DIM", "FLASH_ENABLED", "FLASH_MIN_KV", "SHORT_FUSED_ENABLED"]

# Auto-selection of K11: off by default, the JAX package's setting. Whether it
# should be on for this card is an open question (PERF.md); ``use_flash=True``
# or flipping the switch selects the kernel.
FLASH_ENABLED = False
FLASH_MIN_KV = 1024
# Auto-selection of K4 for tq == tk <= SHORT_MAX_T: on by default, the JAX
# package's setting; off, every such call takes the plain route.
SHORT_FUSED_ENABLED = True

SHORT_MAX_T = 640   # K and V of a head stay resident in a block's shared memory
HEAD_DIM = 64       # the only head width of the public CLIP towers
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "short_attention_bf16": [_P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _I, _P],
    "short_attention_f32": [_P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _I, _P],
    "flash_attention_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "flash_attention_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}


def _lib_attention():
    return _lib.load("attention_kernels", _SIGNATURES)


def _causal_bias(tq: int, tk: int, q_offset: int = 0,
                 device: tp.Union[str, torch.device] = "cpu") -> torch.Tensor:
    """Additive (tq, tk) causal mask with the query block at ``q_offset``."""
    q_pos = q_offset + torch.arange(tq, device=device)[:, None]
    keep = q_pos >= torch.arange(tk, device=device)[None, :]
    return torch.where(keep, 0.0, -1e30).to(torch.float32)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: tp.Optional[torch.Tensor] = None,
                  scale: tp.Optional[float] = None) -> torch.Tensor:
    """Scaled dot-product attention. q, k, v: (..., T, head_dim); ``mask`` an
    additive mask broadcastable to (..., Tq, Tk). Scores and softmax in f32,
    probabilities rounded to ``v.dtype`` before the PV product."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores + mask
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(weights, v)


def short_attention_packed_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                     num_heads: int, causal: bool = False) -> torch.Tensor:
    """Plain version of K4: heads split by reshape, :func:`mha_reference`."""
    b, t, dm = q.shape
    hd = dm // num_heads

    def split(x):
        return x.reshape(b, t, num_heads, hd).transpose(1, 2)

    mask = _causal_bias(t, t, device=q.device) if causal else None
    o = mha_reference(split(q), split(k), split(v), mask=mask)
    return o.transpose(1, 2).reshape(b, t, dm)


def short_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              causal: bool = False) -> torch.Tensor:
    """Plain version of K12: :func:`mha_reference` on (BH, T, hd)."""
    mask = _causal_bias(q.shape[1], q.shape[1], device=q.device) if causal else None
    return mha_reference(q, k, v, mask=mask)


def _kernel_inputs(q, k, v, shape) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """bf16 or f32 CUDA q/k/v of one shape whose rows the kernel can read 16
    bytes at a time with one (batch, row) stride pair: views of a fused
    projection pass through untouched, anything else is made contiguous."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
        if x.dtype not in (torch.bfloat16, torch.float32) or x.dtype != q.dtype:
            raise TypeError(f"{name}: the kernel takes bfloat16 or float32 (one type for q, k "
                            f"and v), got {x.dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
        if x.requires_grad:
            raise NotImplementedError("the short-attention kernels have no backward; use "
                                      "short_attention_ad / short_attention_packed_ad")

    group = 16 // q.element_size()

    def ok(x):
        return (x.stride(2) == 1 and x.stride(0) % group == 0 and x.stride(1) % group == 0
                and x.data_ptr() % 16 == 0)

    if not (ok(q) and ok(k) and ok(v) and q.stride() == k.stride() == v.stride()):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return q, k, v


def _launch(q, k, v, out, batch: int, heads: int, t: int, causal: bool) -> None:
    entry = "short_attention_bf16" if q.dtype == torch.bfloat16 else "short_attention_f32"
    _lib.check(getattr(_lib_attention(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), batch, heads, t,
        q.stride(0), q.stride(1), out.stride(0), out.stride(1), int(causal),
        _lib.torch_stream()), "short_attention")


def _check_geometry(t: int, hd: int) -> None:
    if hd != HEAD_DIM:
        raise ValueError(f"the short-attention kernels take head dim {HEAD_DIM}, got {hd}")
    if not 0 < t <= SHORT_MAX_T:
        raise ValueError(f"the short-attention kernels take 0 < T <= {SHORT_MAX_T}, got {t}")


def short_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           num_heads: int, causal: bool = False) -> torch.Tensor:
    """K4. q/k/v (B, T, D) with D = num_heads * 64, heads contiguous along the
    last axis -- the natural output of the qkv projection; (B, T, D) out."""
    if q.device.type == "cpu":
        return short_attention_packed_reference(q, k, v, num_heads=num_heads, causal=causal)
    b, t, dm = q.shape
    if dm % num_heads:
        raise ValueError(f"D={dm} is not a multiple of num_heads={num_heads}")
    _check_geometry(t, dm // num_heads)
    q, k, v = _kernel_inputs(q, k, v, (b, t, dm))
    out = torch.empty((b, t, dm), dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, b, num_heads, t, causal)
    short_attention_packed.launches += 1
    return out


short_attention_packed.launches = 0


def short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False) -> torch.Tensor:
    """K12. q/k/v (BH, T, 64) -> (BH, T, 64)."""
    if q.device.type == "cpu":
        return short_attention_reference(q, k, v, causal=causal)
    bh, t, hd = q.shape
    _check_geometry(t, hd)
    q, k, v = _kernel_inputs(q, k, v, (bh, t, hd))
    out = torch.empty((bh, t, hd), dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, bh, 1, t, causal)
    short_attention.launches += 1
    return out


short_attention.launches = 0


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              causal: bool = False, q_offset: int = 0) -> torch.Tensor:
    """Plain version of K11: :func:`mha_reference` with the causal mask of a
    query block at ``q_offset`` folded into one bias."""
    mask = _causal_bias(q.shape[-2], k.shape[-2], q_offset, device=q.device) if causal else None
    return mha_reference(q, k, v, mask=mask)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, q_offset: int = 0) -> torch.Tensor:
    """K11. q (BH, Tq, 64), k/v (BH, Tk, 64), bf16 or f32 -> (BH, Tq, 64).
    With ``causal``, query row i sees keys <= ``q_offset + i`` (the chunked-
    prefill shape: q a late chunk, k/v the whole history). The products run in
    the operand type: tensor cores for bf16, true f32 FMA for f32."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, q_offset=q_offset)
    bh, tq, hd = q.shape
    tk = k.shape[1]
    if hd != HEAD_DIM:
        raise ValueError(f"flash_attention takes head dim {HEAD_DIM}, got {hd}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention takes bfloat16 or float32, got {q.dtype}")
    if q_offset < 0:
        raise ValueError(f"flash_attention takes q_offset >= 0, got q_offset={q_offset}")
    for name, x, shape in (("q", q, (bh, tq, hd)), ("k", k, (bh, tk, hd)), ("v", v, (bh, tk, hd))):
        if not x.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
        if x.dtype != q.dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected {q.dtype} {shape}, got {x.dtype} {tuple(x.shape)}")
        if x.requires_grad:
            raise NotImplementedError("flash_attention has no backward; use flash_attention_ad")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    entry = "flash_attention_bf16" if q.dtype == torch.bfloat16 else "flash_attention_f32"
    _lib.check(getattr(_lib_attention(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, tq, tk, int(causal),
        int(q_offset), _lib.torch_stream()), "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def short_attention_packed_ad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              num_heads: int, causal: bool = False) -> torch.Tensor:
    """Differentiable K4: the kernel forward, the plain version recomputed for
    the backward. The plain version itself on the CPU."""
    kw = dict(num_heads=num_heads, causal=causal)
    if q.device.type == "cpu":
        return short_attention_packed(q, k, v, **kw)
    return recompute_backward(short_attention_packed, short_attention_packed_reference,
                              (q, k, v), kw)


def short_attention_ad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = False) -> torch.Tensor:
    """Differentiable K12 (see :func:`short_attention_packed_ad`)."""
    if q.device.type == "cpu":
        return short_attention(q, k, v, causal=causal)
    return recompute_backward(short_attention, short_attention_reference, (q, k, v),
                              {"causal": causal})


def flash_attention_ad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = False, q_offset: int = 0) -> torch.Tensor:
    """Differentiable K11 (see :func:`short_attention_packed_ad`); the
    backward recomputes the scores in full, as the JAX package's does."""
    kw = dict(causal=causal, q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_attention(q, k, v, **kw)
    return recompute_backward(flash_attention, flash_attention_reference, (q, k, v), kw)


def attention_route(*, on_card: bool, tq: int, tk: int, has_mask: bool, q_offset: int,
                    use_flash: tp.Optional[bool]) -> str:
    """Which of ``"short_packed"`` (K4), ``"flash"`` (K11) or ``"plain"``
    :func:`multi_head_attention` takes: the JAX package's rule with "on the
    card" for "on the TPU". The rule does not look at the type or the head
    width: a call it sends to a kernel that the kernel cannot take raises."""
    if (use_flash is None and SHORT_FUSED_ENABLED and not has_mask and q_offset == 0
            and tq == tk and tk <= SHORT_MAX_T and on_card):
        return "short_packed"
    if use_flash is None:
        use_flash = FLASH_ENABLED and not has_mask and on_card and tk >= FLASH_MIN_KV
    return "flash" if use_flash and not has_mask else "plain"


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         num_heads: int, mask: tp.Optional[torch.Tensor] = None,
                         causal: bool = False, use_flash: tp.Optional[bool] = None,
                         q_offset: int = 0) -> torch.Tensor:
    """Split heads, attend, merge. q/k/v: (B, T, D) with D = H * head_dim.

    :func:`attention_route` picks K4, K11 or the plain route. The plain route
    is :func:`mha_reference` with ``mask``, ``causal`` and ``q_offset`` folded
    into one additive bias; it serves every call the JAX package leaves to XLA
    (an explicit mask, ``tq != tk``, long sequences with the flash switch
    off), on the CPU and on the card alike. An explicit additive ``mask``
    always takes it: the kernels know causal and validity masking only.
    """
    b, tq, dm = q.shape
    tk = k.shape[1]
    hd = dm // num_heads
    route = attention_route(on_card=q.device.type != "cpu", tq=tq, tk=tk,
                            has_mask=mask is not None, q_offset=q_offset, use_flash=use_flash)
    if route == "short_packed":
        return short_attention_packed_ad(q, k, v, num_heads=num_heads, causal=causal)

    def split(x, t):
        return x.reshape(b, t, num_heads, hd).transpose(1, 2)

    qh, kh, vh = split(q, tq), split(k, tk), split(v, tk)
    if route == "flash":
        o = flash_attention_ad(qh.reshape(b * num_heads, tq, hd),
                               kh.reshape(b * num_heads, tk, hd),
                               vh.reshape(b * num_heads, tk, hd), causal=causal,
                               q_offset=q_offset).reshape(b, num_heads, tq, hd)
    else:
        attn_mask = mask
        if causal:
            cmask = _causal_bias(tq, tk, q_offset, device=q.device)
            attn_mask = cmask if attn_mask is None else attn_mask + cmask
        o = mha_reference(qh, kh, vh, mask=attn_mask)
    return o.transpose(1, 2).reshape(b, tq, dm)
