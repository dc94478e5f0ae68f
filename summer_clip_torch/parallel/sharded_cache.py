"""Cache attention sharded over the cache length N (the workload's long axis).

Counterpart of ``summer_clip_tpu/parallel/sharded_cache.py``: the cache rows
(and their values) are split over the ranks of the mesh's ``model`` axis, each
rank runs on its own rows the kernel that the one-device route runs on the
card, and one all-reduce of the (B, Nt, C) partial logits adds the shards. The
test features are on every rank; the (Nt, Nc) weight matrix exists nowhere.

- :func:`sharded_cache_logits` -- host values: each rank takes its rows and
  runs K1 (``ops.cache_kernels.cache_attention``), int8 one-hots as int8;
- :class:`ShardedResidentCache` -- the L2-normalised, prediction-sorted cache
  and its outs resident on the ranks, a selection a row mask: Hard values are
  labels (-1 on masked rows) for K3 where each block is class-grouped and K2
  where it is not (``cache_attention_from_labels``), Softmax values are
  computed on the rank (zero on masked rows) for K1.

Rows pad with zero values (labels -1) to whole ``ROW_PAD`` blocks per rank,
the alignment of the port's one-device residence, so pad rows add exactly
nothing. The kernels return f32 partials and the all-reduce adds them in f32:
no class sum is rounded to bf16 between the shards. There is no fallback: on
the card each rank launches its kernel or raises.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from summer_clip_torch.ops.cache_kernels import cache_attention, cache_attention_from_labels
from summer_clip_torch.parallel.mesh import Mesh, all_reduce

__all__ = ["sharded_cache_logits", "pad_cache_for_mesh", "ShardedResidentCache", "ROW_PAD"]

ROW_PAD = 1024   # rows a rank holds pad to a multiple of this (the one-device residence's)


def _l2n(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def pad_cache_for_mesh(cache_features: np.ndarray, cache_values: np.ndarray, n_shards: int,
                       multiple: int = ROW_PAD) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Zero rows appended until every one of ``n_shards`` shards holds a
    multiple of ``multiple`` rows."""
    n = cache_features.shape[0]
    pad = (-n) % (n_shards * multiple)
    if pad:
        cache_features = np.concatenate(
            [cache_features, np.zeros((pad,) + cache_features.shape[1:], cache_features.dtype)])
        cache_values = np.concatenate(
            [cache_values, np.zeros((pad,) + cache_values.shape[1:], cache_values.dtype)])
    return cache_features, cache_values


def _shard(x: np.ndarray, mesh: Mesh, axis: str) -> np.ndarray:
    per = x.shape[0] // mesh.shape[axis]
    i = mesh.coords[axis]
    return x[i * per:(i + 1) * per]


def _as_tensor(x, device: torch.device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device, dtype)
    return torch.from_numpy(np.asarray(x, np.float32)).to(device, dtype)


def sharded_cache_logits(test_features, cache_features: np.ndarray, cache_values: np.ndarray,
                         betas, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """(B, Nt, C) f32 logits on ``mesh.device`` with the cache's rows split
    over ``axis``: K1 on this rank's rows, then the all-reduce. Every rank
    passes the whole cache (host arrays) and takes its rows; integer values
    (one-hots) stay int8 on the card."""
    dev = mesh.device
    vals = np.asarray(cache_values)
    as_int8 = np.issubdtype(vals.dtype, np.integer) and dev.type == "cuda"
    cf, cv = pad_cache_for_mesh(np.asarray(cache_features, np.float32),
                                vals.astype(np.int8 if as_int8 else np.float32),
                                mesh.shape[axis])
    c_shard = torch.from_numpy(np.ascontiguousarray(_shard(cf, mesh, axis))).to(dev)
    v_shard = torch.from_numpy(np.ascontiguousarray(_shard(cv, mesh, axis))).to(dev)
    bet = torch.atleast_1d(torch.as_tensor(betas, dtype=torch.float32)).to(dev)
    part = cache_attention(_as_tensor(test_features, dev), c_shard, v_shard, bet)
    return all_reduce(part, mesh, axis)


class ShardedResidentCache:
    """The cache's features and outs resident on the ranks, rows split over
    ``axis``.

    The grid-sweep counterpart of the one-device residence of
    ``apps/image_attention.py``: the rows are L2-normalised in f32, sorted by
    predicted class (``argmax`` of the outs as they reside, so a bf16
    residence does not flip a tie row's class) and uploaded once, each rank
    its contiguous block of ``ROW_PAD``-aligned rows. A selection is then a row
    mask: masked rows carry label -1 (Hard) or zero values (Softmax), which
    add nothing, so no rows move between ranks; the only collective is the
    all-reduce of the (B, Nt, C) partials.

    Unlike a one-device gather, masked rows still ride through the dense
    kernel (K1); the label kernels (K2, K3) skip them on the host."""

    def __init__(self, cache_features: np.ndarray, cache_outs: np.ndarray, mesh: Mesh,
                 axis: str = "model", resident_dtype: torch.dtype = torch.float32):
        self.mesh, self.axis = mesh, axis
        self.n_rows = int(cache_features.shape[0])
        co = np.asarray(cache_outs, np.float32)
        preds = (torch.from_numpy(co).to(resident_dtype).float().numpy()
                 .argmax(axis=1).astype(np.int32))
        order = np.argsort(preds, kind="stable")
        self._rank = np.empty_like(order)          # original id -> sorted position
        self._rank[order] = np.arange(order.size)
        cf, co = pad_cache_for_mesh(_l2n(np.asarray(cache_features, np.float32))[order],
                                    co[order], mesh.shape[axis])
        self.padded_rows = cf.shape[0]
        self.rows_per_rank = self.padded_rows // mesh.shape[axis]
        self._start = mesh.coords[axis] * self.rows_per_rank
        pred_p = np.full(self.padded_rows, -1, np.int32)
        pred_p[:self.n_rows] = preds[order]
        self._preds = _shard(pred_p, mesh, axis)   # this rank's rows' classes, -1 on pads
        self.num_classes = int(co.shape[1])
        dev = mesh.device
        self.features = torch.from_numpy(np.ascontiguousarray(_shard(cf, mesh, axis))).to(
            dev, resident_dtype)
        self.outs = torch.from_numpy(np.ascontiguousarray(_shard(co, mesh, axis))).to(
            dev, resident_dtype)

    def _local_rows(self, inds) -> np.ndarray:
        """This rank's rows (local positions) of the selection ``inds``
        (original row ids)."""
        pos = self._rank[np.asarray(inds, np.int64)] - self._start
        return pos[(pos >= 0) & (pos < self.rows_per_rank)]

    def logits(self, test_norm, inds, betas, kind: str = "hard",
               scale: float = 1.0) -> torch.Tensor:
        """(B, Nt, C) f32 cache logits of the selected rows ``inds`` (original
        row order) on ``mesh.device``, the same on every rank of the axis."""
        if kind not in ("hard", "softmax"):
            raise ValueError(f"unknown value kind: {kind}")
        dev = self.mesh.device
        test = _as_tensor(test_norm, dev)
        bet = torch.atleast_1d(torch.as_tensor(betas, dtype=torch.float32)).to(dev)
        local = self._local_rows(inds)
        if kind == "hard":
            labels = np.full(self.rows_per_rank, -1, np.int32)
            labels[local] = self._preds[local]
            part = cache_attention_from_labels(test, self.features, labels, bet, self.num_classes)
        else:
            mask = torch.zeros(self.rows_per_rank, dtype=torch.float32)
            mask[torch.from_numpy(local)] = 1.0
            v = torch.softmax(scale * self.outs.float(), dim=1) * mask.to(dev)[:, None]
            part = cache_attention(test, self.features, v.to(torch.bfloat16) if dev.type == "cuda"
                                   else v, bet)
        return all_reduce(part, self.mesh, self.axis)
