"""Tip-Adapter: training-free cache classifier + hyperparameter search.

Counterpart of ``summer_clip_tpu/methods/tip.py``. The beta axis of the grid
search runs through the label-driven cache kernels in chunks of 16 betas (one
call per chunk); every alpha's blend of a chunk, its argmax and the hits against
the labels are one call of :func:`blend_argmax_hits` (K14 on the card, which
writes no blend), and the best point is the first maximum in grid order.
Tip-Adapter-F (:func:`finetune_cache_keys`) trains the cache keys on the plain
f32 route: the cache kernels are forward-only, and the JAX function has no
kernel either.

Spans and counters of a search (:mod:`summer_clip_torch.core.profiling`):
``tip.search`` (``tip.searches``) around each chunk's ``tip.cache`` (the
kernel call; ``tip.chunks``, ``tip.betas``) and ``tip.blend`` (the blend,
argmax and accuracies; ``tip.blended``, the betas blended) with its host copy
``tip.fetch``; ``tip.points`` adds the size of every accuracy array a chunk
produced.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from summer_clip_torch.core import profiling
from summer_clip_torch.core.device import resolve_device
from summer_clip_torch.engine.optim import adamw, cosine_decay_schedule
from summer_clip_torch.ops.cache_kernels import blend_argmax_hits, cache_attention_auto

__all__ = ["build_cache_from_features", "tip_logits", "search_hp", "beta_alpha_grid",
           "finetune_cache_keys"]


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
               cache_labels=None, device: tp.Union[None, str, torch.device] = None) -> torch.Tensor:
    """Single-point Tip-Adapter logits (features/keys already normalized), on
    ``device`` (the card when None)."""
    device = resolve_device(device)
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
              device: tp.Union[None, str, torch.device] = None) -> tp.Tuple[float, float, float]:
    """Grid-search (beta, alpha) on ``device`` (the card when None); returns
    (best_beta, best_alpha, best_acc)."""
    with profiling.span("tip.search"):
        profiling.count("tip.searches")
        device = resolve_device(device)
        betas, alphas = beta_alpha_grid(search_scale, search_step)
        f = _t(features, device)
        cl = _t(clip_logits, device)
        keys = _t(cache_keys, device)
        vals = _t(cache_values, device)
        y = torch.as_tensor(np.asarray(labels), dtype=torch.long).to(device)

        best = (-1.0, 0.0, 0.0)  # acc, beta, alpha
        for s in range(0, len(betas), beta_chunk):
            chunk = betas[s:s + beta_chunk]
            profiling.count("tip.chunks")
            profiling.count("tip.betas", len(chunk))
            with profiling.span("tip.cache"):
                cache = cache_attention_auto(f, keys, vals, chunk, cache_labels=cache_labels)
            with profiling.span("tip.blend"):
                # (Bc, A) rows whose blend's argmax is their label -> accuracy per (beta, alpha)
                hits = blend_argmax_hits(cache, cl, y, alphas)
                profiling.count("tip.blended", cache.shape[0])
                del cache   # one chunk's logits live at a time
                with profiling.span("tip.fetch"):
                    accs = (hits.float() / y.shape[0] * 100.0).cpu().numpy()
                profiling.count("tip.points", accs.size)
            bi, ai = np.unravel_index(np.argmax(accs), accs.shape)
            if accs[bi, ai] > best[0]:
                best = (float(accs[bi, ai]), float(chunk[bi]), float(alphas[ai]))
                if log_fn:
                    log_fn({"type": "tip_hp", "beta": best[1], "alpha": best[2],
                            "acc": best[0]})
        return best[1], best[2], best[0]


def finetune_cache_keys(train_features, train_labels, clip_logits_train, cache_keys,
                        cache_values, beta: float, alpha: float, *, epochs: int = 20,
                        lr: float = 1e-3, batch_size: int = 256, weight_decay: float = 0.01,
                        seed: int = 0, log_fn: tp.Optional[tp.Callable[[dict], None]] = None,
                        device: tp.Union[None, str, torch.device] = None) -> np.ndarray:
    """Tip-Adapter-F: fine-tune the cache keys as a bias-free linear layer.

    The keys (NK, D) start from the training-free cache and are trained in
    f32; the one-hot values stay frozen. Loss: CE over ``clip_logits + alpha *
    exp(-beta (1 - f @ keys^T)) @ values`` on the few-shot train set; AdamW
    (``eps=1e-4``) over optax's cosine decay, mini-batches in the order of
    ``np.random.RandomState(seed).permutation`` each epoch, as the JAX
    function draws them. f32 products with TF32 off. Logs a ``tipf_epoch``
    record per epoch; returns the trained keys (NK, D). ``device``: the card
    when None."""
    device = resolve_device(device)
    f = _t(train_features, device)
    y = torch.as_tensor(np.asarray(train_labels), dtype=torch.long).to(device)
    cl = _t(clip_logits_train, device)
    vals = _t(cache_values, device)
    keys = _t(cache_keys, device).clone().requires_grad_(True)

    n = f.shape[0]
    batch_size = min(batch_size, n)
    steps_per_epoch = max(n // batch_size, 1)
    tx = adamw({"keys": keys}, cosine_decay_schedule(lr, max(epochs * steps_per_epoch, 1)),
               weight_decay=weight_decay, eps=1e-4)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rng = np.random.RandomState(seed)
        for epoch in range(int(epochs)):
            order = torch.from_numpy(rng.permutation(n)).to(device)
            losses = []
            for s in range(steps_per_epoch):
                idx = order[s * batch_size:(s + 1) * batch_size]
                cache = torch.exp(-beta * (1.0 - f[idx] @ keys.t())) @ vals
                loss = F.cross_entropy(cl[idx] + alpha * cache, y[idx])
                tx.zero_grad()
                loss.backward()
                tx.step()
                losses.append(loss.detach())
            if log_fn:
                mean = np.mean(torch.stack(losses).cpu().numpy().astype(np.float64))
                log_fn({"type": "tipf_epoch", "epoch": epoch, "loss": float(mean)})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return keys.detach().cpu().numpy()
