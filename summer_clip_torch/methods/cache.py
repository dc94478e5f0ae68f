"""CLIP-search cache strategies: selection, values, weights.

The thesis method's strategy grid (SURVEY.md §2.3; reference
``summer_clip/clip_searcher/cache_{strategy,value_strategy,weights_strategy}.py``):

- **selection** strategies pick which train-cache rows participate,
- **value** strategies turn cached logits into soft/hard label values,
- **weights** strategies score test-vs-cache affinity.

Counterpart of ``summer_clip_tpu/methods/cache.py``. Selection is *host-side
numpy* with the same seeded generators as there (cheap, inherently
dynamic-shaped -- it picks ragged index sets), so both packages select the same
rows bit for bit. The weights x values contraction is the device hot path,
served by the cache-attention kernels in
:mod:`summer_clip_torch.ops.cache_kernels` with the beta sweep batched.

Array conventions: features (N, D) row-major; outs (N, C).
"""

from __future__ import annotations

import typing as tp
from abc import ABC, abstractmethod

import numpy as np

import torch

from summer_clip_torch.core.device import resolve_device
from summer_clip_torch.ops.cache_kernels import cache_attention_auto

__all__ = [
    "CacheStrategy", "IndexedCacheStrategy", "AllLogitsStrategy",
    "ThresholdStrategy", "TopKStrategy", "TopKProbStrategy",
    "TopKPerGoldStrategy", "TopKPerGoldProbStrategy",
    "GlobalRandomSampleStrategy", "PerGoldClassRandomSampleStrategy",
    "PerPredClassRandomSampleStrategy", "select_topk_per_label",
    "select_k_random_per_label",
    "CacheValueStrategy", "HardCacheStrategy", "SoftmaxCacheStrategy",
    "CacheWeightsStrategy", "TipAdapterWeightsStrategy", "cache_logits_for_betas",
]


def _softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


# ---------------------------------------------------------------------------
# Selection strategies
# ---------------------------------------------------------------------------

class CacheStrategy(ABC):
    """Transforms (features, outs) into the cache actually used."""

    @abstractmethod
    def transform(self, image_features: np.ndarray, image_outs: np.ndarray
                  ) -> tp.Tuple[np.ndarray, np.ndarray]:
        ...


class IndexedCacheStrategy(CacheStrategy):
    """Strategies that reduce to row selection."""

    @abstractmethod
    def select(self, image_features: np.ndarray, image_outs: np.ndarray) -> np.ndarray:
        ...

    def transform(self, image_features, image_outs):
        inds = self.select(image_features, image_outs)
        return image_features[inds], image_outs[inds]


class AllLogitsStrategy(IndexedCacheStrategy):
    def select(self, image_features, image_outs):
        return np.arange(image_outs.shape[0])


class ThresholdStrategy(IndexedCacheStrategy):
    """Keep rows whose max (soft)probability clears a confidence threshold."""

    def __init__(self, threshold: float, use_softmax: bool = True):
        self.threshold = threshold
        self.use_softmax = use_softmax

    def select(self, image_features, image_outs):
        probs = _softmax(image_outs, axis=1) if self.use_softmax else image_outs
        return np.flatnonzero(probs.max(axis=1) >= self.threshold)


def select_topk_per_label(labels: np.ndarray, scores: np.ndarray, topk: int) -> np.ndarray:
    """For each distinct label, the global indices of its top-k scoring rows."""
    picks = []
    for label in np.unique(labels):
        rows = np.flatnonzero(labels == label)
        k = min(topk, rows.shape[0])
        local = np.argpartition(-scores[rows], kth=k - 1)[:k]
        picks.append(rows[local])
    return np.concatenate(picks) if picks else np.zeros((0,), np.int64)


class TopKStrategy(IndexedCacheStrategy):
    """Top-k most confident rows per *predicted* class."""

    def __init__(self, topk: int):
        self.topk = topk

    def select(self, image_features, image_outs):
        preds = image_outs.argmax(axis=1)
        conf = image_outs.max(axis=1)
        return select_topk_per_label(preds, conf, self.topk)


class TopKProbStrategy(IndexedCacheStrategy):
    """TopK on temperature-scaled softmax probabilities."""

    def __init__(self, topk: int, scale: float):
        self.scale = scale
        self.inner = TopKStrategy(topk)

    def select(self, image_features, image_outs):
        return self.inner.select(image_features, _softmax(image_outs * self.scale, axis=1))


class TopKPerGoldStrategy(IndexedCacheStrategy):
    """Oracle variant: top-k by the *gold* class score (needs cache labels)."""

    def __init__(self, topk: int, cache_labels: tp.Union[np.ndarray, tp.Sequence[int], tp.Any]):
        self.topk = topk
        self.cache_labels = _coerce_labels(cache_labels)

    def select(self, image_features, image_outs):
        labels = self.cache_labels
        gold_scores = np.take_along_axis(image_outs, labels[:, None].astype(np.int64), axis=1)[:, 0]
        return select_topk_per_label(labels, gold_scores, self.topk)


class TopKPerGoldProbStrategy(IndexedCacheStrategy):
    def __init__(self, topk: int, cache_labels, scale: float):
        self.scale = scale
        self.inner = TopKPerGoldStrategy(topk, cache_labels)

    def select(self, image_features, image_outs):
        return self.inner.select(image_features, _softmax(image_outs * self.scale, axis=1))


class GlobalRandomSampleStrategy(IndexedCacheStrategy):
    """k * C random rows, class-agnostic.

    Without an explicit seed, randomness comes from the module-level numpy
    state, which ``set_random_state`` seeds per run — matching the
    reference's reproducibility behavior (cache_strategy.py:108-117).
    """

    def __init__(self, topk: int, seed: tp.Optional[int] = None):
        self.topk = topk
        self.rng = np.random.default_rng(seed) if seed is not None else np.random

    def select(self, image_features, image_outs):
        n, c = image_outs.shape
        size = min(self.topk * c, n)
        return self.rng.choice(n, size=size, replace=False)


def select_k_random_per_label(labels: np.ndarray, k: int,
                              rng: tp.Optional[tp.Any] = None) -> np.ndarray:
    rng = rng if rng is not None else np.random
    picks = []
    for label in np.unique(labels):
        rows = np.flatnonzero(labels == label)
        kk = min(k, rows.shape[0])
        picks.append(rng.choice(rows, size=kk, replace=False))
    return np.concatenate(picks) if picks else np.zeros((0,), np.int64)


class PerGoldClassRandomSampleStrategy(IndexedCacheStrategy):
    def __init__(self, topk: int, cache_labels, seed: tp.Optional[int] = None):
        self.topk = topk
        self.cache_labels = _coerce_labels(cache_labels)
        self.rng = np.random.default_rng(seed) if seed is not None else np.random

    def select(self, image_features, image_outs):
        return select_k_random_per_label(self.cache_labels, self.topk, self.rng)


class PerPredClassRandomSampleStrategy(IndexedCacheStrategy):
    def __init__(self, topk: int, seed: tp.Optional[int] = None):
        self.topk = topk
        self.rng = np.random.default_rng(seed) if seed is not None else np.random

    def select(self, image_features, image_outs):
        preds = image_outs.argmax(axis=1)
        return select_k_random_per_label(preds, self.topk, self.rng)


def _coerce_labels(labels) -> np.ndarray:
    """Accept an array, a list, or a dataset-like (iterable of Datum)."""
    if hasattr(labels, "labels") and callable(labels.labels):
        return np.asarray(labels.labels(), np.int64)
    if hasattr(labels, "__iter__") and not isinstance(labels, np.ndarray):
        items = list(labels)
        if items and hasattr(items[0], "label"):
            return np.asarray([it.label for it in items], np.int64)
        return np.asarray(items, np.int64)
    return np.asarray(labels, np.int64)


# ---------------------------------------------------------------------------
# Value strategies
# ---------------------------------------------------------------------------

class CacheValueStrategy(ABC):
    @abstractmethod
    def transform(self, cache_outs: np.ndarray) -> np.ndarray:
        ...


class HardCacheStrategy(CacheValueStrategy):
    """One-hot of the predicted class (half precision in the reference).

    Emitted as int8: exact for one-hots, 1 byte per entry of value traffic;
    the dense kernel converts them per tile."""

    def transform(self, cache_outs):
        n, c = cache_outs.shape
        out = np.zeros((n, c), np.int8)
        out[np.arange(n), cache_outs.argmax(axis=1)] = 1
        return out


class SoftmaxCacheStrategy(CacheValueStrategy):
    """softmax(clip_scale * scale * outs) soft pseudo-labels."""

    def __init__(self, clip_scale: float, scale: float):
        self.clip_scale = clip_scale
        self.scale = scale

    def transform(self, cache_outs):
        return _softmax(self.clip_scale * self.scale * np.asarray(cache_outs, np.float32), axis=1)


# ---------------------------------------------------------------------------
# Weights strategies (device hot path)
# ---------------------------------------------------------------------------

class CacheWeightsStrategy(ABC):
    """Affinity of test features against the cache.

    On the device the weight matrix is deliberately **never materialized**: use
    :func:`cache_logits_for_betas` which fuses weights @ values. ``transform``
    exists for oracle tests / small problems.
    """

    @abstractmethod
    def transform(self, test_image_features: np.ndarray,
                  cache_image_features: np.ndarray) -> np.ndarray:
        ...


def _l2n(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


class TipAdapterWeightsStrategy(CacheWeightsStrategy):
    """``exp(-beta (1 - f_hat @ c_hat.T))`` (reference cache_weights_strategy.py:28-36)."""

    def __init__(self, beta: float):
        self.beta = beta

    def transform(self, test_image_features, cache_image_features):
        a = _l2n(np.asarray(test_image_features, np.float32)) @ \
            _l2n(np.asarray(cache_image_features, np.float32)).T
        return np.exp(-self.beta * (1.0 - a))


def cache_logits_for_betas(test_features, cache_features, cache_values,
                           betas: tp.Sequence[float], *, normalize: bool = True,
                           cache_labels: tp.Optional[np.ndarray] = None,
                           device: tp.Union[None, str, torch.device] = None) -> torch.Tensor:
    """Fused (B, Nt, C) cache logits over a beta sweep (the hot path), f32 on
    ``device`` (the card when None).

    Replaces the reference's per-beta weight recompute
    (``image_attention.py:106-110``). Pass ``cache_labels`` when
    ``cache_values`` is one_hot(labels): the sweep then takes the
    label-driven kernels (K3 / K2); otherwise the dense kernel (K1). Features
    are normalised in f32 on the host; the kernels round them to bf16 on
    CUDA. Integer values (int8 one-hots) stay int8 on CUDA and become f32 on
    the CPU, floating values are f32 until the kernel rounds them.
    """
    device = resolve_device(device)

    def _norm(x) -> np.ndarray:
        x = np.asarray(x, np.float32)
        if normalize:
            x = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
        return x

    f = torch.from_numpy(_norm(test_features)).to(device)
    c = torch.from_numpy(_norm(cache_features)).to(device)
    vals = np.asarray(cache_values)
    if np.issubdtype(vals.dtype, np.integer) and device.type == "cuda":
        v = torch.from_numpy(vals.astype(np.int8)).to(device)
    else:
        v = torch.from_numpy(vals.astype(np.float32)).to(device)
    bet = torch.as_tensor(np.asarray(list(betas), np.float32)).to(device)
    if cache_labels is not None:
        cache_labels = np.asarray(cache_labels, np.int32)
    return cache_attention_auto(f, c, v, bet, cache_labels=cache_labels)
