"""Attention ops: plain PyTorch reference + hand-written short-sequence kernels.

Counterpart of ``summer_clip_tpu/ops/attention.py``:

- :func:`mha_reference` -- scaled dot-product attention in plain PyTorch with
  the JAX package's rounding (f32 scores and softmax, probabilities rounded to
  the value dtype before the PV product). The oracle and the CPU path.
- :func:`short_attention_packed` -- K4, one-pass softmax attention on the
  packed (B, T, H * hd) layout. CUDA source ``csrc/attention_kernels.cu``
  (``short_attention``); replaces the TPU kernel ``short_attention_packed``
  (ops/attention.py:248).
- :func:`short_attention` -- K12, the same device code on (BH, T, hd);
  replaces the TPU kernel ``short_attention`` (ops/attention.py:195).
- :func:`multi_head_attention` -- split heads, attend, merge, with the JAX
  package's selection rule (``ops/attention.py:420-426``).

On a CPU tensor the wrappers run their plain version; on a CUDA tensor they
launch the kernel or raise, never the plain version. The kernels take bf16,
head dim 64 and T <= :data:`SHORT_MAX_T`; they have no backward yet (the JAX
package recomputes it in XLA, ``:338-361``), so inputs that require grad raise
on CUDA. ``flash_attention`` (K11) is not ported: where the JAX package would
pick it, :func:`multi_head_attention` raises ``NotImplementedError`` on CUDA.
"""

from __future__ import annotations

import ctypes
import typing as tp

import torch

from summer_clip_torch.ops import _lib

__all__ = ["mha_reference", "short_attention", "short_attention_packed",
           "short_attention_packed_reference", "multi_head_attention",
           "SHORT_MAX_T", "HEAD_DIM"]

SHORT_MAX_T = 640   # one computing warp's score rows still fit beside K and V of a head
HEAD_DIM = 64       # the only head width of the public CLIP towers
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "short_attention_bf16": [_P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _I, _P],
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


def _kernel_inputs(q, k, v, shape) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """bf16 CUDA q/k/v of one shape whose rows the kernel can read 16 bytes at
    a time with one (batch, row) stride pair: views of a fused projection pass
    through untouched, anything else is made contiguous."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bfloat16, got {x.dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
        if x.requires_grad:
            raise NotImplementedError("the short-attention kernels have no backward yet")

    def ok(x):
        return (x.stride(2) == 1 and x.stride(0) % 8 == 0 and x.stride(1) % 8 == 0
                and x.data_ptr() % 16 == 0)

    if not (ok(q) and ok(k) and ok(v) and q.stride() == k.stride() == v.stride()):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return q, k, v


def _launch(q, k, v, out, batch: int, heads: int, t: int, causal: bool) -> None:
    _lib.check(_lib_attention().short_attention_bf16(
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
        mask = _causal_bias(q.shape[1], q.shape[1]) if causal else None
        return mha_reference(q, k, v, mask=mask)
    bh, t, hd = q.shape
    _check_geometry(t, hd)
    q, k, v = _kernel_inputs(q, k, v, (bh, t, hd))
    out = torch.empty((bh, t, hd), dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, bh, 1, t, causal)
    short_attention.launches += 1
    return out


short_attention.launches = 0


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         num_heads: int, mask: tp.Optional[torch.Tensor] = None,
                         causal: bool = False, use_flash: tp.Optional[bool] = None,
                         q_offset: int = 0) -> torch.Tensor:
    """Split heads, attend, merge. q/k/v: (B, T, D) with D = H * head_dim.

    On CUDA the JAX package's rule picks the kernel: no explicit ``mask``,
    ``q_offset == 0`` and ``tq == tk <= SHORT_MAX_T`` run K4; every other
    call is one the JAX package sends to XLA or to ``flash_attention``
    (K11), which is not ported, and raises. On a CPU tensor the plain version
    runs with the mask, ``causal`` and ``q_offset`` folded into one bias.
    """
    b, tq, dm = q.shape
    tk = k.shape[1]
    hd = dm // num_heads
    if q.device.type != "cpu":
        if (use_flash is None and mask is None and q_offset == 0 and tq == tk
                and tk <= SHORT_MAX_T and dm == num_heads * hd):
            return short_attention_packed(q, k, v, num_heads=num_heads, causal=causal)
        raise NotImplementedError(
            "multi_head_attention on CUDA runs only the short packed kernel (no mask, "
            f"q_offset 0, tq == tk <= {SHORT_MAX_T}); flash_attention is not ported")

    def split(x, t):
        return x.reshape(b, t, num_heads, hd).transpose(1, 2)

    attn_mask = mask
    if causal:
        cmask = _causal_bias(tq, tk, q_offset, device=q.device)
        attn_mask = cmask if attn_mask is None else attn_mask + cmask
    o = mha_reference(split(q, tq), split(k, tk), split(v, tk), mask=attn_mask)
    return o.transpose(1, 2).reshape(b, tq, dm)
