"""ClipGPT pretraining. Only the loss is ported so far (``apps/gen_gpt`` reports
perplexity with it); the trainer of ``summer_clip_tpu/apps/train_gpt.py`` is not
ported yet."""

from __future__ import annotations

import torch

__all__ = ["lm_loss_fn"]


def lm_loss_fn(logits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Causal-LM shifted cross-entropy with labels == inputs, written as
    ``logsumexp - target_logit`` in f32 so that the normalised (B, T, V)
    log-softmax is never built."""
    lg = logits[:, :-1]
    tgt = lg.gather(-1, ids[:, 1:, None].long())[..., 0].to(torch.float32)
    lse = torch.logsumexp(lg.to(torch.float32), dim=-1)
    return (lse - tgt).mean()
