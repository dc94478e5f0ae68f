"""Zero-shot classifier building and accuracy metrics.

Counterpart of ``summer_clip_tpu/methods/zeroshot.py``: every class x template
prompt is tokenized into one (C*T, 77) batch and pushed through the text tower
in fixed chunks of 256 prompts. Features are row-major (N, D), the classifier
(C, D), logits ``100 * f_norm @ w.T``.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from summer_clip_torch.core.device import resolve_device
from summer_clip_torch.models import tokenizer as tokenizer_mod

__all__ = ["zeroshot_classifier", "accuracy", "compute_accuracy", "clip_logits",
           "label_rank"]


def label_rank(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Rank of ``labels[i]`` in ``logits[i]`` under top-k's lowest-index
    tiebreak: ``#(strictly greater) + #(equal at an earlier index)``."""
    labels = labels.long()
    lab = logits.gather(1, labels[:, None])
    idx = torch.arange(logits.shape[1], device=logits.device)[None, :]
    return ((logits > lab).sum(1) + ((logits == lab) & (idx < labels[:, None])).sum(1))


def zeroshot_classifier(encode_text: tp.Callable[[torch.Tensor], torch.Tensor],
                        classnames: tp.Sequence[str], templates: tp.Sequence[str],
                        tokenizer: tp.Optional[tp.Any] = None, chunk_size: int = 256,
                        context_length: int = 77,
                        device: tp.Union[None, str, torch.device] = None) -> torch.Tensor:
    """(C, D) L2-normalized prompt-ensemble classifier (f32, on ``device``,
    the card when None).

    ``encode_text`` maps (B, 77) token ids on ``device`` to (B, D) features.
    Per class: encode every template, normalize, average, re-normalize.
    """
    device = resolve_device(device)
    prompts = []
    for name in classnames:
        clean = str(name).replace("_", " ")
        prompts.extend(t.format(clean) for t in templates)
    tokens = tokenizer_mod.tokenize(prompts, context_length=context_length,
                                    tokenizer=tokenizer)
    n_total = tokens.shape[0]
    pad_total = -(-n_total // chunk_size) * chunk_size
    tokens_padded = np.zeros((pad_total, tokens.shape[1]), np.int64)
    tokens_padded[:n_total] = tokens
    tokens_padded[n_total:, 0] = tokens[0, 0] if n_total else 0
    tok = torch.from_numpy(tokens_padded).to(device)
    feats = torch.cat([encode_text(tok[s:s + chunk_size])
                       for s in range(0, pad_total, chunk_size)])[:n_total].float()
    feats = feats.reshape(len(classnames), len(templates), -1)
    feats = feats / feats.norm(dim=-1, keepdim=True)
    mean = feats.mean(dim=1)
    return mean / mean.norm(dim=-1, keepdim=True)


def clip_logits(image_features: torch.Tensor, classifier: torch.Tensor,
                scale: float = 100.0) -> torch.Tensor:
    """``scale * normalize(f) @ w.T`` -- the zero-shot logits (Nt, C)."""
    f = image_features.float()
    f = f / f.norm(dim=-1, keepdim=True)
    return scale * f @ classifier.float().t()


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def accuracy(logits, labels, topk: tp.Sequence[int] = (1,)) -> tp.List[float]:
    """Top-k accuracies in percent (host numpy, as the JAX package)."""
    logits = _np(logits)
    labels = _np(labels)
    max_k = max(topk)
    top = np.argpartition(-logits, kth=min(max_k, logits.shape[1] - 1), axis=1)[:, :max_k]
    row_scores = np.take_along_axis(logits, top, axis=1)
    order = np.argsort(-row_scores, axis=1)
    top = np.take_along_axis(top, order, axis=1)
    return [float((top[:, :k] == labels[:, None]).any(axis=1).mean() * 100.0) for k in topk]


def compute_accuracy(logits, labels) -> tp.Tuple[float, float]:
    """(acc@1, acc@5) pair."""
    k5 = min(5, _np(logits).shape[1])
    a1, a5 = accuracy(logits, labels, topk=(1, k5))
    return a1, a5
