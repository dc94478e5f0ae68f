"""ProLIP: few-shot fine-tuning of CLIP's final vision projection.

Counterpart of ``summer_clip_tpu/methods/prolip.py`` ("CLIP's Visual Embedding
Projector is a Few-shot Cornucopia", arXiv:2410.05270): train only the
(width, embed_dim) vision projection W on the few-shot split, with
cross-entropy over cosine-similarity logits against the frozen class text
embeddings and an L2 pull toward the pretrained W0. The tuned W replaces the
original, so every downstream consumer (zero-shot eval, Tip-Adapter caches,
CLIP-search) takes it unchanged (``clip.proj_path``).

The problem is small (N = shots x classes rows of width 768 or 1024), so
training is full-batch: ``epochs`` Adam steps on one device, the per-step
losses read back once at the end. No kernel of the port is on this path.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from summer_clip_torch.core.device import resolve_device
from summer_clip_torch.engine.optim import adam

__all__ = ["prolip_logits", "train_projection"]


def prolip_logits(feats_pre, W, classifier, scale: float = 100.0,
                  device: tp.Union[None, str, torch.device] = None) -> torch.Tensor:
    """Cosine-similarity logits of pre-projection features under projection W.

    ``classifier``: (C, embed_dim), rows L2-normalised (the
    ``methods.zeroshot.zeroshot_classifier`` output). Arrays or tensors, moved
    to ``device`` (the card when None) as f32; the logits lie there."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                               dtype=torch.float32, device=dev)

    img = F.normalize(t(feats_pre) @ t(W), dim=-1)
    return scale * img @ t(classifier).t()


def train_projection(feats_pre, labels, classifier, W0, *, epochs: int = 200,
                     lr: float = 1e-4, weight_decay_to_init: float = 1.0,
                     scale: float = 100.0, log_fn: tp.Optional[tp.Callable] = None,
                     log_every: int = 20,
                     device: tp.Union[None, str, torch.device] = None) -> np.ndarray:
    """Fine-tune the vision projection on few-shot (feats_pre, labels).

    Loss = CE(scale * cos(x W, T), y) + lambda * mean((W - W0)^2): the L2
    anchor to the pretrained W0 keeps the few-shot fit from destroying the
    open-vocabulary geometry (arXiv:2410.05270 section 3.2). ``epochs``
    full-batch steps of ``torch.optim.Adam`` (through ``engine.optim.adam``),
    whose update is optax's ``adam``: bias-corrected moments, eps outside the
    square root. f32 with TF32 off, on ``device`` (the card when None). Logs
    ``prolip_train`` records of the loss before the steps ``0, log_every, ...``
    and before the last step, as the JAX function does; returns W (f32)."""
    device = resolve_device(device)
    x = torch.as_tensor(np.asarray(feats_pre, np.float32), device=device)
    y = torch.as_tensor(np.asarray(labels), dtype=torch.long, device=device)
    T = torch.as_tensor(np.asarray(classifier, np.float32), device=device)
    W0t = torch.as_tensor(np.asarray(W0, np.float32), device=device)
    W = W0t.clone().requires_grad_()
    lam = float(weight_decay_to_init)
    tx = adam({"W": W}, float(lr))
    losses, ces = [], []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for _ in range(int(epochs)):
            ce = F.cross_entropy(prolip_logits(x, W, T, scale, device), y)
            loss = ce + lam * ((W - W0t) ** 2).mean()
            tx.zero_grad()
            loss.backward()
            tx.step()
            losses.append(loss.detach())
            ces.append(ce.detach())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if log_fn is not None and losses:
        losses_np = torch.stack(losses).cpu().numpy()
        ces_np = torch.stack(ces).cpu().numpy()
        for e in list(range(0, int(epochs), max(1, int(log_every)))) + [int(epochs) - 1]:
            log_fn({"type": "prolip_train", "epoch": int(e),
                    "loss": float(losses_np[e]), "ce": float(ces_np[e])})
    return W.detach().cpu().numpy().astype(np.float32)
