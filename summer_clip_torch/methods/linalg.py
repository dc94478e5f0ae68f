"""Linear-algebra analysis methods: Mahalanobis classifier and PCA projection.

Counterpart of ``summer_clip_tpu/methods/linalg.py``:

- :func:`maha_logits`: covariance of [cache image features; text features]
  (the unnormalised scatter matrix, as the reference's ``torch.cov * (n - 1)``),
  its inverse ``M``, and the quadratic form ``(x - t) M (x - t)`` for every
  (test, class) pair expanded as ``xMx + tMt - 2 xMt``: three products, no
  (Nt, C, D) broadcast.
- :class:`PCA`: SVD fit on the text features, one projection shared with the
  image features. A singular vector's sign is the library's choice, so a
  component may come out negated against the JAX package's; the projected
  cosine logits do not change.

f32 throughout; the products run where the inputs are put (``device``), with
TF32 left off (PyTorch's default for matrix products).
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from summer_clip_torch.core.device import resolve_device

__all__ = ["maha_logits", "PCA"]


def _f32(x, device) -> torch.Tensor:
    """An array or tensor as an f32 tensor on ``device``."""
    return torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x),
                           dtype=torch.float32).to(device)


def maha_logits(test_features, text_features, cache_features, eps: float = 1e-4,
                device: tp.Union[None, str, torch.device] = None) -> torch.Tensor:
    """Negative Mahalanobis distances as logits (Nt, C); higher = closer.

    All features row-major (N, D), L2-normalized by the caller; computed on
    ``device`` (the card when None)."""
    device = resolve_device(device)
    x = _f32(test_features, device)
    t = _f32(text_features, device)
    cache = _f32(cache_features, device)

    stacked = torch.cat([cache, t], dim=0)
    centered = stacked - stacked.mean(dim=0, keepdim=True)
    cov = centered.t() @ centered
    cov = cov + eps * torch.eye(cov.shape[0], device=cov.device)
    m = torch.linalg.inv(cov)

    xm = x @ m
    tm = t @ m
    xmx = (xm * x).sum(dim=1)
    tmt = (tm * t).sum(dim=1)
    cross = xm @ t.t()
    return -(xmx[:, None] + tmt[None, :] - 2.0 * cross)


class PCA:
    """Minimal SVD PCA with the sklearn fit/transform surface, on ``device``
    (the card when None)."""

    def __init__(self, n_components: int, device: tp.Union[None, str, torch.device] = None):
        self.n_components = n_components
        self.device = resolve_device(device)
        self.mean_: tp.Optional[torch.Tensor] = None
        self.components_: tp.Optional[torch.Tensor] = None

    def fit(self, x) -> "PCA":
        x = _f32(x, self.device)
        self.mean_ = x.mean(dim=0)
        _, _, vt = torch.linalg.svd(x - self.mean_[None], full_matrices=False)
        self.components_ = vt[: self.n_components]
        return self

    def transform(self, x) -> torch.Tensor:
        assert self.components_ is not None, "fit first"
        return (_f32(x, self.device) - self.mean_[None]) @ self.components_.t()

    def fit_transform(self, x) -> torch.Tensor:
        return self.fit(x).transform(x)
