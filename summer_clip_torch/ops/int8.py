"""Int8 inference products for the frozen CLIP towers (opt-in, ``clip.quant=int8``).

Counterpart of ``summer_clip_tpu/ops/int8.py``, with its recipe and its
rounding points:

- weights: symmetric per-output-channel int8, the scales taken from the f32
  parameters at call time (the parameter tree stays that of the float
  towers);
- activations: symmetric int8 with a dynamic max-abs scale, one per row for a
  dense layer and one per tensor for a convolution;
- ``max|x| / 127`` floored at 1e-12; ``round`` half to even, then clipped to
  +-127;
- int8 x int8 -> int32 sums, rescaled in f32 (``acc * x_scale * w_scale``),
  the bias added in f32, the result cast to the module dtype.

The JAX package has no Pallas kernel here: its products are XLA's int8 dots.
On the card the sums are ``torch._int_mm`` (a convolution is an im2col,
``F.unfold``, then the same product); its shape rules (more than 16 rows, K
and N multiples of 8; cuBLASLt refuses 17 rows) are met by zero rows and
columns, at least 32 rows and every count a multiple of 8, which leave the
sums exact. On the CPU they are an int32 matmul of the same int8 operands. Both
give the same int32 sums.

Under ``jit`` XLA turns the division by the constant 127 into a product with
its f32 reciprocal; the scales here are computed that way, so ``q`` and the
scales equal the jitted JAX functions' bit for bit.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F

__all__ = ["quantize_rows", "quantize_cols", "int8_sums", "int8_dense", "int8_linear",
           "int8_conv2d", "QUANT_MODES", "check_quant"]

QUANT_MODES = (None, "int8")
_INV127 = 1.0 / 127.0


def check_quant(quant: tp.Optional[str]) -> tp.Optional[str]:
    if quant not in QUANT_MODES:
        raise ValueError(f"unknown quant mode: {quant!r} (takes one of {QUANT_MODES})")
    return quant


def _quantize(x: torch.Tensor, amax: torch.Tensor) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp_min(amax * _INV127, 1e-12)
    return torch.round(x / scale).clamp(-127, 127).to(torch.int8), scale


def quantize_rows(x: torch.Tensor) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: (m, k) -> ((m, k) int8, (m, 1) f32 scale)."""
    x = x.to(torch.float32)
    return _quantize(x, x.abs().amax(dim=-1, keepdim=True))


def quantize_cols(w: torch.Tensor) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-column int8: (k, n) -> ((k, n) int8, (n,) f32 scale)."""
    w = w.to(torch.float32)
    return _quantize(w, w.abs().amax(dim=0))


def _pad_to(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return F.pad(x, (0, cols - x.shape[1], 0, rows - x.shape[0])) if (
        rows, cols) != tuple(x.shape) else x


def int8_sums(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """(m, k) int8 @ (k, n) int8 -> (m, n) int32, exact. ``torch._int_mm`` on
    the card (zero rows / columns up to its shape rules), an int32 matmul on
    the CPU."""
    m, k = x8.shape
    n = w8.shape[1]
    if x8.device.type == "cpu":
        return torch.matmul(x8.to(torch.int32), w8.to(torch.int32))
    mp, kp, np_ = max(-(-m // 8) * 8, 32), -(-k // 8) * 8, -(-n // 8) * 8
    acc = torch._int_mm(_pad_to(x8, mp, kp).contiguous(), _pad_to(w8, kp, np_).contiguous())
    return acc[:m, :n]


def int8_dense(x: torch.Tensor, kernel: torch.Tensor, bias: tp.Optional[torch.Tensor] = None,
               out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Quantized ``x @ kernel + bias`` over the trailing dim of ``x``:
    ``kernel`` (k, n) f32, as the JAX package stores it."""
    shape = x.shape
    x8, x_scale = quantize_rows(x.reshape(-1, shape[-1]))
    w8, w_scale = quantize_cols(kernel)
    y = int8_sums(x8, w8).to(torch.float32) * x_scale * w_scale
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(out_dtype).reshape(*shape[:-1], kernel.shape[-1])


def int8_linear(x: torch.Tensor, weight: torch.Tensor, bias: tp.Optional[torch.Tensor] = None,
                out_dtype: tp.Optional[torch.dtype] = None) -> torch.Tensor:
    """:func:`int8_dense` on an ``nn.Linear``'s (out, in) weight; the result
    in ``out_dtype`` (``x``'s dtype when None)."""
    return int8_dense(x, weight.t(), bias, out_dtype or x.dtype)


def int8_conv2d(x: torch.Tensor, weight: torch.Tensor, stride: int = 1, padding: int = 0,
                out_dtype: tp.Optional[torch.dtype] = None) -> torch.Tensor:
    """The JAX package's int8 ``QuantConv`` (bias-free) on NCHW ``x`` and an
    OIHW weight: one activation scale for the whole tensor, one weight scale
    per output channel, the int32 sums as an im2col product."""
    b, c, h, w = x.shape
    o, _, kh, kw = weight.shape
    x32 = x.to(torch.float32)
    x8, x_scale = _quantize(x32, x32.abs().amax())
    w32 = weight.to(torch.float32)
    w8, w_scale = _quantize(w32, w32.abs().amax(dim=(1, 2, 3), keepdim=True))
    # im2col of the int8 values (exact in f32): (B, C*kh*kw, L), channel-major
    cols = F.unfold(x8.to(torch.float32), (kh, kw), padding=padding, stride=stride)
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    rows = cols.transpose(1, 2).reshape(b * ho * wo, c * kh * kw).to(torch.int8)
    acc = int8_sums(rows, w8.reshape(o, c * kh * kw).t())
    y = acc.to(torch.float32) * x_scale * w_scale.reshape(o)
    return y.to(out_dtype or x.dtype).reshape(b, ho, wo, o).permute(0, 3, 1, 2)
