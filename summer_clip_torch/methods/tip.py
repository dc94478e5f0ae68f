"""Tip-Adapter: training-free cache classifier + hyperparameter search.

Counterpart of ``summer_clip_tpu/methods/tip.py`` (training-free part;
``finetune_cache_keys`` is not ported yet). The beta axis of the grid search
runs through the label-driven cache kernels in chunks of 16 betas (one call
per chunk), alphas are a broadcast blend, and the best point is the first
maximum in grid order.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from summer_clip_torch.ops.cache_kernels import cache_attention_auto

__all__ = ["build_cache_from_features", "tip_logits", "search_hp", "beta_alpha_grid"]


def build_cache_from_features(feature_passes: tp.Sequence[np.ndarray], labels: np.ndarray,
                              num_classes: tp.Optional[int] = None
                              ) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Average augment passes -> normalized keys (NK, D); one-hot values (NK, C)."""
    keys = np.mean(np.stack(feature_passes, 0), axis=0).astype(np.float32)
    keys /= np.maximum(np.linalg.norm(keys, axis=-1, keepdims=True), 1e-12)
    labels = np.asarray(labels, np.int64)
    c = int(num_classes if num_classes is not None else labels.max() + 1)
    values = np.zeros((labels.shape[0], c), np.float32)
    values[np.arange(labels.shape[0]), labels] = 1.0
    return keys, values


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(device)


def tip_logits(clip_logits, features, cache_keys, cache_values, beta: float, alpha: float,
               cache_labels=None, device: tp.Union[str, torch.device] = "cpu") -> torch.Tensor:
    """Single-point Tip-Adapter logits (features/keys already normalized)."""
    cache = cache_attention_auto(_t(features, device), _t(cache_keys, device),
                                 _t(cache_values, device), [beta],
                                 cache_labels=cache_labels)[0]
    return _t(clip_logits, device) + cache * alpha


def beta_alpha_grid(search_scale: tp.Sequence[float], search_step: tp.Sequence[int]
                    ) -> tp.Tuple[np.ndarray, np.ndarray]:
    """The reference's grid parameterization (utils.py:103-104)."""
    betas = np.asarray([i * (search_scale[0] - 0.1) / search_step[0] + 0.1
                        for i in range(search_step[0])], np.float32)
    alphas = np.asarray([i * (search_scale[1] - 0.1) / search_step[1] + 0.1
                         for i in range(search_step[1])], np.float32)
    return betas, alphas


def search_hp(features, labels, clip_logits, cache_keys, cache_values,
              search_scale: tp.Sequence[float] = (7, 3),
              search_step: tp.Sequence[int] = (200, 20), beta_chunk: int = 16,
              log_fn: tp.Optional[tp.Callable[[dict], None]] = None, cache_labels=None,
              device: tp.Union[str, torch.device] = "cpu") -> tp.Tuple[float, float, float]:
    """Grid-search (beta, alpha); returns (best_beta, best_alpha, best_acc)."""
    betas, alphas = beta_alpha_grid(search_scale, search_step)
    f = _t(features, device)
    cl = _t(clip_logits, device)
    keys = _t(cache_keys, device)
    vals = _t(cache_values, device)
    y = torch.as_tensor(np.asarray(labels), dtype=torch.long).to(device)
    alphas_t = torch.as_tensor(alphas).to(device)

    best = (-1.0, 0.0, 0.0)  # acc, beta, alpha
    for s in range(0, len(betas), beta_chunk):
        chunk = betas[s:s + beta_chunk]
        cache = cache_attention_auto(f, keys, vals, chunk, cache_labels=cache_labels)
        # (Bc, A, Nt, C) blends -> argmax per row -> accuracy per (beta, alpha)
        accs = torch.stack([
            ((cl[None] + alphas_t[:, None, None] * c[None]).argmax(-1) == y[None])
            .float().mean(-1) * 100.0
            for c in cache]).cpu().numpy()
        bi, ai = np.unravel_index(np.argmax(accs), accs.shape)
        if accs[bi, ai] > best[0]:
            best = (float(accs[bi, ai]), float(chunk[bi]), float(alphas[ai]))
            if log_fn:
                log_fn({"type": "tip_hp", "beta": best[1], "alpha": best[2], "acc": best[0]})
    return best[1], best[2], best[0]
