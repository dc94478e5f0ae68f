"""Plain cache arithmetic: Tip-Adapter's (beta, alpha) grid and CLIP-search's
(value, beta, alpha) grid, written from the published methods.

Tip-Adapter (Zhang et al., 2022): cache logits ``exp(-beta (1 - f k^T)) v``
with one-hot values ``v``, blended as ``clip + alpha * cache``; the search
keeps the first best top-1 accuracy in grid order. CLIP-search: the same
weights over the whole unlabeled cache with soft values
``softmax(100 * scale * outs)``; top-1 and top-5 by the rank of the label
under top-k's lowest-index tiebreak.

Every product in float32 with TF32 off, in blocks of test rows so that the
(rows, cache) weights fit. ``dtype`` computes the same in another precision
(the control of the correctness check): features, weights, values, cache
logits and blends in it, the accuracies counted in float32.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

ROW_BLOCK = 4096


def l2n(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def beta_alpha_grid(scale: tp.Sequence[float], step: tp.Sequence[int]
                    ) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Tip-Adapter's grid (its ``utils.py``): ``i * (scale - 0.1) / step + 0.1``."""
    betas = np.asarray([i * (scale[0] - 0.1) / step[0] + 0.1 for i in range(step[0])], np.float32)
    alphas = np.asarray([i * (scale[1] - 0.1) / step[1] + 0.1 for i in range(step[1])], np.float32)
    return betas, alphas


def label_rank(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Rank of each row's label: strictly greater scores, then equal scores at
    an earlier index."""
    lab = logits.gather(1, labels[:, None])
    idx = torch.arange(logits.shape[1], device=logits.device)[None, :]
    return (logits > lab).sum(1) + ((logits == lab) & (idx < labels[:, None])).sum(1)


def tip_grid(features: torch.Tensor, labels: torch.Tensor, clip_logits: torch.Tensor,
             keys: torch.Tensor, key_labels: torch.Tensor, num_classes: int,
             betas: np.ndarray, alphas: np.ndarray,
             dtype: torch.dtype = torch.float32) -> np.ndarray:
    """(betas, alphas) top-1 accuracy in percent of Tip-Adapter's blend."""
    n = features.shape[0]
    alpha_t = torch.as_tensor(alphas, dtype=dtype, device=features.device)
    correct = torch.zeros(len(betas), len(alphas), dtype=torch.float64, device=features.device)
    k = keys.to(dtype)
    for s in range(0, n, ROW_BLOCK):
        f = features[s:s + ROW_BLOCK].to(dtype)
        aff = f @ k.t()
        cl = clip_logits[s:s + ROW_BLOCK].to(dtype)
        y = labels[s:s + ROW_BLOCK]
        for bi, beta in enumerate(betas):
            w = torch.exp(-float(beta) * (1.0 - aff))
            cache = torch.zeros(f.shape[0], num_classes, dtype=dtype, device=f.device)
            cache.index_add_(1, key_labels, w)
            pred = (cl[None] + alpha_t[:, None, None] * cache[None]).argmax(-1)
            correct[bi] += (pred == y[None]).sum(-1)
    return (correct / n * 100.0).cpu().numpy()


def zeroshot_classifier(text_features: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(C * T, D) prompt features -> (C, D): each normalized, averaged over
    the templates, normalized again."""
    feats = l2n(text_features.float()).reshape(n_classes, -1, text_features.shape[-1])
    return l2n(feats.mean(dim=1))


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> tp.Tuple[float, float]:
    rank = label_rank(logits, labels)
    k5 = min(5, logits.shape[1])
    return (float((rank == 0).double().mean() * 100.0), float((rank < k5).double().mean() * 100.0))


def clip_search_grid(test_norm: torch.Tensor, labels: torch.Tensor, clip_logits: torch.Tensor,
                     cache_features: torch.Tensor, outs: torch.Tensor,
                     value_scales: tp.Sequence[float], clip_scale: float,
                     betas: tp.Sequence[float], alphas: tp.Sequence[float],
                     dtype: torch.dtype = torch.float32) -> np.ndarray:
    """(values, betas, alphas, 2) top-1 / top-5 accuracy in percent of the
    whole-cache search with soft values."""
    n = test_norm.shape[0]
    cache = l2n(cache_features.float()).to(dtype)
    values = [torch.softmax(clip_scale * float(s) * outs.float(), dim=1).to(dtype)
              for s in value_scales]
    hits = torch.zeros(len(values), len(betas), len(alphas), 2, dtype=torch.float64,
                       device=test_norm.device)
    k5 = min(5, clip_logits.shape[1])
    for s in range(0, n, ROW_BLOCK):
        aff = test_norm[s:s + ROW_BLOCK].to(dtype) @ cache.t()
        cl = clip_logits[s:s + ROW_BLOCK].to(dtype)
        y = labels[s:s + ROW_BLOCK]
        for bi, beta in enumerate(betas):
            w = torch.exp(-float(beta) * (1.0 - aff))
            for vi, v in enumerate(values):
                logits = w @ v
                for ai, alpha in enumerate(alphas):
                    rank = label_rank((cl + float(alpha) * logits).float(), y)
                    hits[vi, bi, ai, 0] += (rank == 0).sum()
                    hits[vi, bi, ai, 1] += (rank < k5).sum()
    return (hits / n * 100.0).cpu().numpy()
