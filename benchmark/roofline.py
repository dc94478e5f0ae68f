"""Peaks of one NVIDIA H100 and the work each measured kernel or layer needs.

A roofline share is the least time the card could take for a kernel's work
over the device time the kernel took. The least time is the larger of the
bytes at the memory rate and the operations at the peak rate of their type:
each input byte read once and each output byte written once, whatever a kernel
reads again; products on the tensor cores at the bf16 rate or on the FP32
lanes at the f32 rate. The counts are copied from ``chip_smoke.bound`` and
``chip_smoke.label_bound`` (they are the benchmark's yardstick here, so a
later change to the program's own copies moves nothing), with one change:
exponentials.

Exponentials. The special-function units retire 16 ``ex2`` a clock an SM
(CUDA C Programming Guide, "Arithmetic Instructions", throughput table,
compute capability 9.0). A kernel may compute some exponentials on the FP32
lanes instead (128 a clock an SM, same table): range reduction, a polynomial
and the exponent inserted by integer arithmetic. The cheapest such
exponential accurate to bf16 (the precision the cache kernels round their
weights to) is taken as four lane instructions (one reduction, a degree-two
polynomial in two fused multiply-adds, one exponent insert), so the card
could reach at most 16 + 128 / 4 = 48 exponentials a clock an SM with both
units together. Counting at that rate keeps every share at or under 100%
whichever units a kernel uses. The work charged is the algorithm's: one
exponential per (query, cache row, beta), whatever computes it.
"""

from __future__ import annotations

import dataclasses
import subprocess

PEAK_BYTES = 3.35e12      # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
PEAK_BF16 = 989e12        # dense bf16 tensor-core FLOP/s (data sheet, no sparsity)
PEAK_F32 = 67e12          # f32 FLOP/s outside the tensor cores (data sheet)
SFU_EXP_PER_CLOCK_SM = 16
FP32_LANES_PER_CLOCK_SM = 128
SOFTWARE_EXP_INSTRUCTIONS = 4
EXP_PER_CLOCK_SM = SFU_EXP_PER_CLOCK_SM + FP32_LANES_PER_CLOCK_SM / SOFTWARE_EXP_INSTRUCTIONS
H100_SMS = 132
H100_MAX_SM_CLOCK_HZ = 1.98e9


@dataclasses.dataclass(frozen=True)
class Card:
    sms: int = H100_SMS
    sm_clock_hz: float = H100_MAX_SM_CLOCK_HZ

    @property
    def exp_rate(self) -> float:
        """Exponentials a second with both units busy (module docstring)."""
        return EXP_PER_CLOCK_SM * self.sms * self.sm_clock_hz


def read_card() -> Card:
    """The SM count and maximum SM clock of card 0 (H100 SXM values where
    ``nvidia-smi`` does not answer)."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = H100_MAX_SM_CLOCK_HZ
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True,
                             timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            clock = float(out.stdout.strip().splitlines()[0]) * 1e6
    except (OSError, ValueError, subprocess.TimeoutExpired):
        pass
    return Card(sms=sms, sm_clock_hz=clock)


def card_line() -> str:
    """``name, power.limit`` of card 0 as ``nvidia-smi`` prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "unknown"


@dataclasses.dataclass(frozen=True)
class Work:
    """What a call needs: bytes moved, bf16 and f32 operations, exponentials."""
    bytes: float = 0.0
    bf16_flops: float = 0.0
    f32_flops: float = 0.0
    exps: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.bf16_flops + other.bf16_flops,
                    self.f32_flops + other.f32_flops, self.exps + other.exps)

    def __mul__(self, n: float) -> "Work":
        return Work(self.bytes * n, self.bf16_flops * n, self.f32_flops * n, self.exps * n)

    __rmul__ = __mul__


def least_seconds(work: Work, card: Card = Card()) -> float:
    """The larger of bytes at the memory rate and operations at their peak
    rates; exponentials run beside the other units (``chip_smoke.bound``)."""
    by_bytes = work.bytes / PEAK_BYTES
    by_ops = max(work.bf16_flops / PEAK_BF16 + work.f32_flops / PEAK_F32,
                 work.exps / card.exp_rate)
    return max(by_bytes, by_ops)


# -- the towers ----------------------------------------------------------------

def attention(b: int, t: int, d: int, heads: int, causal: bool = False) -> Work:
    """K4 on bf16 q, k, v (B, T, D): q, k, v read and o written once; QK^T and
    PV on the tensor cores (a causal row reaches (t + 1) / 2 keys); one
    exponential a score."""
    keys = (t + 1) / 2 if causal else t
    return Work(bytes=4 * b * t * d * 2, bf16_flops=4 * b * t * keys * d,
                exps=b * heads * t * keys)


def fused_attn_half(b: int, t: int, d: int, heads: int, causal: bool = False) -> Work:
    """K5, ``x + out_proj(MHA(LN(x)))``: x read and written, the in_proj and
    out_proj weights and biases read once (bf16), f32 LayerNorm parameters;
    in_proj, attention and out_proj products."""
    rows = b * t
    keys = (t + 1) / 2 if causal else t
    return Work(bytes=2 * rows * d * 2 + (4 * d * d + 4 * d) * 2 + 2 * d * 4,
                bf16_flops=2 * rows * d * 3 * d + 4 * b * t * keys * d + 2 * rows * d * d,
                exps=b * heads * t * keys)


def fused_mlp_half(b: int, t: int, d: int, hidden: int) -> Work:
    """K6, ``x + c_proj(QuickGELU(c_fc(LN(x))))``: x read and written, both
    weights and biases read once; the two products."""
    rows = b * t
    return Work(bytes=2 * rows * d * 2 + (2 * d * hidden + hidden + d) * 2 + 2 * d * 4,
                bf16_flops=2 * 2 * rows * d * hidden)


def block_chain(b: int, t: int, d: int, heads: int, hidden: int) -> Work:
    """One residual block as the K5 + K6 chains compute it."""
    return fused_attn_half(b, t, d, heads) + fused_mlp_half(b, t, d, hidden)


def vit_image_flops(image: int, patch: int, width: int, layers: int, embed: int,
                    mlp_ratio: int = 4) -> float:
    """Products of one image through a CLIP ViT image tower, from the
    published shapes: patch embedding, every projection, QK^T and PV, and the
    final projection (multiply-adds counted as two operations)."""
    grid = image // patch
    t = grid * grid + 1
    patch_embed = 2 * grid * grid * (3 * patch * patch) * width
    per_block = (2 * t * width * 3 * width + 4 * t * t * width + 2 * t * width * width
                 + 2 * 2 * t * width * mlp_ratio * width)
    return patch_embed + layers * per_block + 2 * width * embed


# -- the cache layer -------------------------------------------------------------

def label_cache(nt: int, nc: int, d: int, c: int, betas: int) -> Work:
    """K2 / K3 (``chip_smoke.label_bound``): bf16 features and int32 labels
    read once, the f32 output written once; the affinity's products on the
    tensor cores, one exponential and one f32 add a (query, row, beta)."""
    return Work(bytes=2 * (nt + nc) * d + 4 * nc + 4 * betas * nt * c,
                bf16_flops=2 * nt * nc * d, f32_flops=betas * nt * nc,
                exps=betas * nt * nc)


def dense_cache(nt: int, nc: int, d: int, c: int, betas: int) -> Work:
    """K1: bf16 features and values read once, the f32 output written once;
    the affinity's products and, a beta, the weights-by-values products on the
    tensor cores; one exponential a (query, row, beta)."""
    return Work(bytes=2 * (nt + nc) * d + 2 * nc * c + 4 * betas * nt * c,
                bf16_flops=2 * nt * nc * d + betas * 2 * nt * nc * c,
                exps=betas * nt * nc)


def tip_search(nt: int, nc: int, d: int, c: int, betas: int, alphas: int) -> Work:
    """A whole Tip-Adapter (beta, alpha) search: the label cache over every
    beta, then a beta's alpha blend ``clip + alpha * cache`` and its argmax
    over every row: the zero-shot logits and the cache logits read once a
    beta and an add and a multiply an element an alpha, f32."""
    blend = Work(bytes=2 * 4 * nt * c, f32_flops=2 * alphas * nt * c)
    return label_cache(nt, nc, d, c, betas) + betas * blend


def clip_search_pass(nt: int, nc: int, d: int, c: int, betas: int, alphas: int,
                     values: int) -> Work:
    """One CLIP-search pass over the whole cache with soft values: a value
    strategy's softmax over the (Nc, C) outs, K1 over every beta, then a
    beta's blend and rank of the label over every alpha (f32)."""
    softmax = Work(bytes=4 * nc * c + 2 * nc * c, exps=nc * c)
    blend = Work(bytes=2 * 4 * nt * c, f32_flops=3 * alphas * nt * c)
    return values * (softmax + dense_cache(nt, nc, d, c, betas) + betas * blend)
