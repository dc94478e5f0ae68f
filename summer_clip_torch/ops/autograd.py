"""The backward of every kernel wrapper: the plain version recomputed.

Counterpart of the JAX package's ``custom_vjp`` pairs (``fused_ln_attn_ad``,
``fused_ln_mlp_ad``, ``short_attention_ad``, ``short_attention_packed_ad``,
``flash_attention_ad``): none of its kernels has a backward kernel, and none
here has one either. The forward launches the kernel on detached inputs and
saves only those inputs (the JAX residuals); the backward runs the plain
PyTorch version on them under ``torch.enable_grad()``, with the module's
rounding points, and returns the gradients of exactly the inputs that need
one.
"""

from __future__ import annotations

import typing as tp

import torch

__all__ = ["recompute_backward"]


class _Recompute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, plain, kwargs, *inputs):
        ctx.plain, ctx.kwargs = plain, kwargs
        ctx.save_for_backward(*inputs)
        return kernel(*(t.detach() for t in inputs), **kwargs)

    @staticmethod
    def backward(ctx, grad):
        inputs = ctx.saved_tensors
        need = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, need)]
            out = ctx.plain(*leaves, **ctx.kwargs)
            grads = iter(torch.autograd.grad(out, [t for t, n in zip(leaves, need) if n], grad))
        return (None, None, None, *(next(grads) if n else None for n in need))


def recompute_backward(kernel: tp.Callable[..., torch.Tensor],
                       plain: tp.Callable[..., torch.Tensor],
                       inputs: tp.Sequence[torch.Tensor],
                       kwargs: tp.Optional[dict] = None) -> torch.Tensor:
    """``kernel(*inputs, **kwargs)`` whose gradient is that of
    ``plain(*inputs, **kwargs)``."""
    return _Recompute.apply(kernel, plain, dict(kwargs or {}), *inputs)
