"""Cache attention ``out[b] = exp(-beta_b * (1 - F @ C^T)) @ V`` (K1, K2, K3).

Counterpart of ``summer_clip_tpu/ops/cache_kernels.py``.

- :func:`cache_attention` -- K1, any value matrix (bf16, or int8 one-hots
  converted per tile). CUDA source ``csrc/cache_kernels.cu``
  (``cache_dense``: wgmma on TMA-staged operands, 16 queries x 256 classes x
  8 betas a block; :func:`k1_grid`, :func:`k1_feature_stages`); replaces the
  TPU kernel ``cache_attention`` (ops/cache_kernels.py:103). CLIP-search's
  Softmax values take it.

Tip-Adapter's values and CLIP-search's Hard values are ``one_hot(labels)``, so
their sweeps take the label-driven kernels, which never build the matrix:

- :func:`cache_attention_onehot` -- K3, for class-grouped caches; replaces
  the TPU kernel ``onehot_pallas`` (ops/cache_kernels.py:394).
- :func:`cache_attention_labels` -- K2, any row order; replaces the TPU
  kernel ``labels_dense_pallas`` (ops/cache_kernels.py:509).

The sweep tool ``tools/torch_sweep_onehot_variants.py`` takes a fourth:

- :func:`onehot_variant` -- K13, K3 with the class partial sums of each
  ``block_n``-row cache block formed apart and added to the output in one of
  three precisions (``expand_mode``); replaces the TPU kernel
  ``onehot_variant`` (tools/sweep_onehot_variants.py:38). Its plain version is
  :func:`onehot_variant_reference`.

K2, K3 and K13 are one class-grouped template in ``csrc/cache_kernels.cu``
(``grouped_kernel``, templated on K13's mode): the cache rows sorted by class
on the host (:func:`class_row_table`) and gathered once on the device into that
order, 64 queries a block walking 128-row tiles of them, the affinity by wgmma,
the exponentials and the class sums in registers. :func:`grouped_plan` builds
its host tables (the row order, the class and segment boundaries, the work
items and the workspace slots of the classes an item boundary cuts) and
:func:`grouped_items` the number of work items.

:func:`cache_attention_from_labels` routes between them by the same test as the
JAX package (``:678-685``): K3 when every ``block_n``-row cache block spans at
most ``k_limit`` classes, K2 otherwise. :func:`cache_attention_auto` sends a
call with labels there and a call with values only to K1.

On a CPU tensor the wrappers run their plain PyTorch version
(:func:`cache_attention_dense_reference`,
:func:`cache_attention_labels_reference`); on a CUDA tensor they launch the
kernel or raise. The CUDA kernels take bf16 features (the wrappers cast, as the
JAX package casts to its compute dtype) and return f32.
"""

from __future__ import annotations

import ctypes
import typing as tp

import numpy as np
import torch

from summer_clip_torch.ops import _lib

__all__ = ["cache_attention_reference", "cache_attention_dense_reference",
           "cache_attention_labels_reference", "cache_attention",
           "cache_attention_onehot", "cache_attention_labels",
           "cache_attention_from_labels", "cache_attention_auto",
           "onehot_block_classes", "onehot_k_max", "class_row_table", "grouped_plan",
           "grouped_items", "GroupedPlan", "onehot_variant",
           "onehot_variant_reference", "EXPAND_MODES", "k1_grid", "k1_feature_stages",
           "k1_shared_bytes"]

K3_MAX_BETA = 16   # betas per K2 / K3 / K13 launch (4 threads a query, 4 betas each)
GROUPED_QUERIES = 64   # queries of a K2 / K3 / K13 block (test rows pad to it)
GROUPED_ROWS = 128     # sorted cache rows of a tile (the sorted rows pad to it)
# a sorted row's meta word: its class, bit 31 where a class begins, bit 30 where a
# segment begins (K13: a class or a block_n block); padding rows are class _NONE
_CLS_START, _SEG_START, _NONE = 1 << 31, 1 << 30, (1 << 30) - 1
K1_MAX_BETA = 8    # betas per K1 launch (their weight tiles share one affinity tile)
K1_MAX_D = 1152    # widest feature row whose query boxes leave K1 a ring (k1_feature_stages)
K1_ROWS = 16       # queries of a K1 block (test rows pad to it)
K1_CACHE_STEP = 128   # cache rows of a K1 step: two 64-row k-blocks (cache rows pad to it)
K1_CLASSES = 256   # classes of a K1 block (value columns pad to it)
# K1's shared memory (csrc/cache_kernels.cu, namespace k1): 64 x 64 bf16 boxes
_K1_BOX, _K1_QBOX, _K1_MAX_STAGES, _K1_SMEM_LIMIT, _K1_VSLOTS = 8192, 2048, 12, 232448, 2
_K1_VBOXES = K1_CLASSES // 64
_K1_FIXED = 1024 + 2 * 2 * 8192 + 8 * (12 + 2 + 4 + 1)   # alignment, w, barriers
_P, _I = ctypes.c_void_p, ctypes.c_int
_K1_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
_GROUPED_ARGS = [_P] * 10 + [_I] * 8
_SIGNATURES = {
    "cache_dense_bf16": _K1_ARGS,
    "cache_dense_i8": _K1_ARGS,
    "cache_dense_feature_stages": [_I, _I],
    "affinity_probe_bf16": [_P, _P, _P, _I, _I, _P],
    "labels_dense_bf16": _GROUPED_ARGS + [_P],
    "onehot_grouped_bf16": _GROUPED_ARGS + [_P],
    "onehot_variant_bf16": _GROUPED_ARGS + [_I, _P],
    "grouped_stages": [_I],
    "weight_rate_probe_bf16": [_P, _P, _I, _I, _P],
}
# K13's precisions of the class-sum scatter, in the kernel's numbering
EXPAND_MODES = ("highest", "split3", "default")


def _lib_cache():
    return _lib.load("cache_kernels", _SIGNATURES)


def k1_shared_bytes(d: int, int8_values: bool, stages: int) -> int:
    """Shared memory of a K1 block at feature width ``d``: the query boxes,
    two value tiles in flight (int8: 64 x 256 bytes, plus a bf16 conversion a
    warpgroup; bf16: four 64 x 64 boxes), two weight buffers, the barriers and
    ``stages`` 64 x 64 feature boxes of the ring."""
    nd = -(-d // 64)
    values = (_K1_VSLOTS * _K1_VBOXES * _K1_BOX // 2 + 2 * _K1_VBOXES * _K1_BOX if int8_values
              else _K1_VSLOTS * _K1_VBOXES * _K1_BOX)
    return _K1_FIXED + nd * _K1_QBOX + values + stages * _K1_BOX


def k1_feature_stages(d: int, int8_values: bool) -> int:
    """Feature-ring stages K1 takes at width ``d``: what shared memory leaves,
    at most 12, rounded down to an even number (a stage serves one of the two
    warpgroups); 0 where fewer than 4 fit (each warpgroup needs one stage in
    use and one loading)."""
    free = _K1_SMEM_LIMIT - k1_shared_bytes(d, int8_values, 0)
    stages = min(_K1_MAX_STAGES, free // _K1_BOX) & ~1
    return stages if stages >= 4 else 0


def k1_grid(nt: int, c: int) -> tp.Tuple[int, int]:
    """K1's blocks: (query tiles of 16, class slices of 256)."""
    return _ceil_to(max(nt, 1), K1_ROWS) // 16, _ceil_to(max(c, 1), K1_CLASSES) // K1_CLASSES


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def cache_attention_reference(test_features: torch.Tensor, cache_features: torch.Tensor,
                              cache_values: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """Dense oracle in f32. test (Nt, D), cache (Nc, D), values (Nc, C),
    betas (B,) -> (B, Nt, C)."""
    aff = test_features.float() @ cache_features.float().t()
    w = torch.exp(-betas.float().reshape(-1, 1, 1) * (1.0 - aff[None]))
    return torch.einsum("bqn,nc->bqc", w, cache_values.float())


def cache_attention_dense_reference(test_features: torch.Tensor,
                                    cache_features: torch.Tensor,
                                    cache_values: torch.Tensor, betas: torch.Tensor,
                                    compute_dtype: torch.dtype = torch.float32
                                    ) -> torch.Tensor:
    """Plain version of K1 with its rounding points: features and floating
    values rounded to ``compute_dtype`` (integer values are exact), the
    affinity in f32, weights rounded to ``compute_dtype``, ``w @ V`` summed in
    f32, one beta at a time. With ``compute_dtype=float32`` this is
    :func:`cache_attention_reference`."""
    f = test_features.to(compute_dtype).float()
    c = cache_features.to(compute_dtype).float()
    v = cache_values
    v = (v.to(compute_dtype) if v.is_floating_point() else v).float()
    aff = f @ c.t()
    outs = [torch.exp(-float(b) * (1.0 - aff)).to(compute_dtype).float() @ v
            for b in betas.float().reshape(-1).tolist()]
    return torch.stack(outs)


def cache_attention_labels_reference(test_features: torch.Tensor,
                                     cache_features: torch.Tensor,
                                     cache_labels: torch.Tensor, betas: torch.Tensor,
                                     num_classes: int,
                                     compute_dtype: torch.dtype = torch.float32
                                     ) -> torch.Tensor:
    """Plain version of K2 and K3: features rounded to ``compute_dtype``, the
    affinity in f32, weights rounded to ``compute_dtype``, sums in f32.
    ``cache_labels`` (Nc,) int, -1 marks rows that add nothing."""
    f = test_features.to(compute_dtype).float()
    c = cache_features.to(compute_dtype).float()
    labels = cache_labels.to(device=f.device, dtype=torch.long)
    onehot = torch.zeros(labels.shape[0], num_classes, dtype=torch.float32, device=f.device)
    real = labels >= 0
    onehot[real.nonzero()[:, 0], labels[real]] = 1.0
    aff = f @ c.t()
    outs = [torch.exp(-float(b) * (1.0 - aff)).to(compute_dtype).float() @ onehot
            for b in betas.float().tolist()]
    return torch.stack(outs)


def _pick_block_n_onehot(d_p: int, c_p: int, f_bytes: int,
                         budget_bytes: int = 14 * 1024 * 1024) -> int:
    """The cache block size the JAX package's K3 would pick
    (``_pick_blocks_onehot``, its candidates and budget). It says nothing
    about the port's own tiling: it is kept only because the K3/K2 route is
    defined on these blocks, so both packages route a cache alike."""
    candidates = [
        (128, 1024, 8), (128, 512, 8), (128, 512, 4), (128, 256, 4),
        (128, 256, 2), (128, 128, 2), (128, 128, 1),
        (64, 128, 1), (32, 128, 1), (16, 128, 1),
    ]
    for bq, bn, bb in candidates:
        need = (2 * bn * d_p * f_bytes + bq * d_p * f_bytes
                + 2 * bb * bq * c_p * 4 + bq * bn * 4)
        if need <= budget_bytes:
            return bn
    return 128


def onehot_block_classes(labels_padded: np.ndarray, block_n: int
                         ) -> tp.Tuple[np.ndarray, int]:
    """Per-cache-block distinct-class table (numpy copy of the JAX package's
    ``onehot_block_classes``): ``(table (num_n, k_max) padded with -2,
    k_max)``, ``k_max`` the most distinct real labels in a block, rounded up
    to 8."""
    num_n = labels_padded.shape[0] // block_n
    rows = labels_padded.reshape(num_n, block_n)
    uniques = [np.unique(r[r >= 0]) for r in rows]
    need = max((u.shape[0] for u in uniques), default=1)
    k_max = max(8, -(-need // 8) * 8)
    table = np.full((num_n, k_max), -2, np.int32)
    for i, u in enumerate(uniques):
        table[i, : u.shape[0]] = u
    return table, k_max


def onehot_k_max(labels: np.ndarray, num_classes: int, d: int, itemsize: int) -> int:
    """``k_max`` of the JAX K3 blocking for these labels and this geometry."""
    block_n = _pick_block_n_onehot(_ceil_to(d, 128), _ceil_to(max(num_classes, 128), 128),
                                   itemsize)
    padded = np.full((_ceil_to(labels.shape[0], block_n),), -1, np.int32)
    padded[: labels.shape[0]] = labels
    return onehot_block_classes(padded, block_n)[1]


def class_row_table(labels: np.ndarray, num_classes: int) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Host index of K3: the real rows (label >= 0) stably sorted by label,
    and per-class offsets ``offs`` (C + 1,) so that class c owns
    ``rows[offs[c]:offs[c + 1]]``."""
    real = np.flatnonzero(labels >= 0)
    rows = real[np.argsort(labels[real], kind="stable")].astype(np.int32)
    offs = np.searchsorted(labels[rows], np.arange(num_classes + 1), side="left")
    return rows, offs.astype(np.int32)


class GroupedPlan(tp.NamedTuple):
    """Host tables of the class-grouped kernel (K2, K3, K13); see
    :func:`grouped_plan`."""
    order: np.ndarray      # (Np,) int64: cache row of each sorted position (padding: row 0)
    meta: np.ndarray       # (Np,) int32: class | segment start << 30 | class start << 31
    items: np.ndarray      # (n_items + 1,) int32: the tiles of each work item
    slots: np.ndarray      # (n_items, 2) int32: workspace slot of the head / tail piece, or -1
    fix_cls: np.ndarray    # (n_fix,) int32: classes the second pass writes (cut or empty)
    fix_offs: np.ndarray   # (n_fix + 1,) int32: their slots, in item order
    n_slots: int


def grouped_items(n_tiles: int, n_qtiles: int, sms: int) -> int:
    """Work items the sorted rows are cut into: the count at which the
    blocks (``n_qtiles`` x items, one an SM at a time) finish soonest, a block
    costing its tiles plus two (its query load and the ring's fill). One
    where the query tiles alone fill the card; none without a tile."""
    if n_tiles <= 1:
        return n_tiles if n_tiles > 0 else 0
    best, best_cost = 1, None
    for n in range(1, min(n_tiles, -(-4 * sms // max(n_qtiles, 1))) + 1):
        cost = -(-n_qtiles * n // sms) * (-(-n_tiles // n) + 2)
        if best_cost is None or cost < best_cost:
            best, best_cost = n, cost
    return best


def grouped_plan(labels: np.ndarray, num_classes: int, *, n_items: int = 1,
                 block_n: tp.Optional[int] = None) -> GroupedPlan:
    """Host tables of the class-grouped kernel for ``labels`` (Nc,), -1 for
    rows that add nothing.

    The real rows in class order (:func:`class_row_table`, stable), padded to
    whole tiles of ``GROUPED_ROWS``; per sorted row its class and whether a
    class or a segment begins there (a segment is a class's run of rows;
    with ``block_n``, K13's, a run within one ``block_n``-row block of the
    original order); the tiles cut into ``n_items`` work items of equal tile
    counts (at most one per tile); and for each class that an item boundary
    cuts, one workspace slot per item it touches, numbered class by class in
    item order: item i's head slot where it begins inside the class, its
    tail slot where it ends inside it (the same slot when the class spans the
    whole item). ``fix_cls`` lists those classes and the empty ones (no
    slots), which the kernel's second pass writes."""
    rows, offs = class_row_table(labels, num_classes)
    n_real = rows.shape[0]
    n_tiles = -(-n_real // GROUPED_ROWS)
    n_p = n_tiles * GROUPED_ROWS
    order = np.zeros(n_p, np.int64)
    order[:n_real] = rows
    cls = labels[rows].astype(np.int64)
    cls_start = np.ones(n_real, bool)
    cls_start[1:] = cls[1:] != cls[:-1]
    seg_start = cls_start.copy()
    if block_n is not None:
        blk = rows // block_n
        seg_start[1:] |= blk[1:] != blk[:-1]
    meta = np.full(n_p, _NONE, np.int64)
    meta[:n_real] = cls | seg_start.astype(np.int64) << 30 | cls_start.astype(np.int64) << 31
    if n_p > n_real:
        meta[n_real] |= _CLS_START | _SEG_START
    n_items = min(max(n_items, 1), n_tiles)
    items = (np.arange(n_items + 1) * n_tiles // max(n_items, 1)).astype(np.int32)
    first_row = items[:-1].astype(np.int64) * GROUPED_ROWS
    nonempty = offs[1:] > offs[:-1]
    i0 = np.searchsorted(first_row, offs[:-1], side="right") - 1
    i1 = np.searchsorted(first_row, offs[1:] - 1, side="right") - 1
    slots = np.full((n_items, 2), -1, np.int32)
    fix_cls, fix_offs, n_slots = [], [0], 0
    for c in np.flatnonzero(~nonempty | (i1 > i0)):
        if nonempty[c]:
            for i in range(i0[c], i1[c] + 1):
                if i > i0[c]:
                    slots[i, 0] = n_slots
                if i < i1[c]:
                    slots[i, 1] = n_slots
                n_slots += 1
        fix_cls.append(c)
        fix_offs.append(n_slots)
    return GroupedPlan(order, meta.astype(np.uint32).view(np.int32), items, slots,
                       np.asarray(fix_cls, np.int32), np.asarray(fix_offs, np.int32), n_slots)


def _host_labels(cache_labels: tp.Any, nc: int, num_classes: int) -> np.ndarray:
    if isinstance(cache_labels, torch.Tensor):
        cache_labels = cache_labels.detach().cpu().numpy()
    labels = np.asarray(cache_labels, np.int64).reshape(-1).astype(np.int32)
    if labels.shape[0] != nc:
        raise ValueError(f"cache_labels has {labels.shape[0]} rows, cache has {nc}")
    if labels.size and (labels.min() < -1 or labels.max() >= num_classes):
        raise ValueError("cache_labels out of range")
    return labels


def _betas(betas: tp.Any, device: torch.device) -> torch.Tensor:
    return torch.atleast_1d(torch.as_tensor(betas, dtype=torch.float32)).to(device)


def _cuda_features(test_features: torch.Tensor, cache_features: torch.Tensor,
                   rows_to: int, cache_rows_to: tp.Optional[int] = None):
    """bf16, contiguous, D padded to 16, test rows padded to ``rows_to`` (and
    cache rows to ``cache_rows_to``) with zeros."""
    for name, t in (("test_features", test_features), ("cache_features", cache_features)):
        if not t.is_cuda or not t.is_floating_point() or t.dim() != 2:
            raise ValueError(f"{name}: expected a 2-D floating CUDA tensor, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    nt, d = test_features.shape
    nc, d2 = cache_features.shape
    if d != d2:
        raise ValueError(f"feature widths differ: {d} vs {d2}")
    d_p = _ceil_to(d, 16)
    nt_p = _ceil_to(max(nt, 1), rows_to)
    nc_p = nc if cache_rows_to is None else _ceil_to(max(nc, 1), cache_rows_to)
    f = torch.zeros(nt_p, d_p, dtype=torch.bfloat16, device=test_features.device)
    f[:nt, :d] = test_features
    if (nc_p == nc and d_p == d and cache_features.dtype == torch.bfloat16
            and cache_features.is_contiguous() and cache_features.data_ptr() % 16 == 0):
        cf = cache_features      # read in place (K1 reads it by TMA: 16-byte aligned)
    else:
        cf = torch.zeros(nc_p, d_p, dtype=torch.bfloat16, device=cache_features.device)
        cf[:nc, :d] = cache_features
    return f, cf, nt_p, nc_p, d_p


def cache_attention(test_features: torch.Tensor, cache_features: torch.Tensor,
                    cache_values: torch.Tensor, betas: tp.Any) -> torch.Tensor:
    """K1: dense cache attention, (B, Nt, C) f32. test (Nt, D), cache (Nc, D),
    values (Nc, C) floating (rounded to bf16 on CUDA) or int8, any number of
    betas (launched 8 at a time). Takes any Nt, Nc, C and any D <=
    ``K1_MAX_D``: features pad with zero columns, the cache with zero value
    rows, all exact."""
    if test_features.device.type == "cpu":
        return cache_attention_dense_reference(test_features, cache_features, cache_values,
                                               _betas(betas, "cpu"))
    dev = test_features.device
    nt, d = test_features.shape
    nc = cache_features.shape[0]
    if (not cache_values.is_cuda or cache_values.dim() != 2 or cache_values.shape[0] != nc):
        raise ValueError(f"cache_values: expected a CUDA tensor of {nc} rows, got "
                         f"{tuple(cache_values.shape)} on {cache_values.device}")
    if d > K1_MAX_D:
        raise ValueError(f"K1 kernel takes D <= {K1_MAX_D}, got {d}")
    c = cache_values.shape[1]
    as_int8 = not cache_values.is_floating_point()
    if as_int8 and cache_values.dtype != torch.int8:
        raise TypeError(f"integer cache_values must be int8, got {cache_values.dtype}")
    f, cf, nt_p, nc_p, d_p = _cuda_features(test_features, cache_features, K1_ROWS,
                                            K1_CACHE_STEP)
    vdtype = torch.int8 if as_int8 else torch.bfloat16
    c_p = _ceil_to(c, K1_CLASSES)
    if (nc_p == nc and c_p == c and cache_values.dtype == vdtype
            and cache_values.is_contiguous() and cache_values.data_ptr() % 16 == 0):
        v = cache_values
    else:
        v = torch.zeros(nc_p, c_p, dtype=vdtype, device=dev)
        v[:nc, :c] = cache_values
    bet = _betas(betas, dev)
    out = torch.empty(bet.shape[0], nt, c, dtype=torch.float32, device=dev)
    lib = _lib_cache()
    entry = lib.cache_dense_i8 if as_int8 else lib.cache_dense_bf16
    stream = _lib.torch_stream()
    for s in range(0, bet.shape[0], K1_MAX_BETA):
        chunk = bet[s:s + K1_MAX_BETA].contiguous()
        view = out[s:s + K1_MAX_BETA]
        _lib.check(entry(f.data_ptr(), cf.data_ptr(), v.data_ptr(), chunk.data_ptr(),
                         view.data_ptr(), chunk.shape[0], nt, nt_p, nc_p, d_p, c, c_p, stream),
                   "cache_dense")
        cache_attention.launches += 1
    return out


cache_attention.launches = 0


def cache_attention_onehot(test_features: torch.Tensor, cache_features: torch.Tensor,
                           cache_labels: tp.Any, betas: tp.Any,
                           num_classes: int) -> torch.Tensor:
    """K3: ``cache_attention`` with ``values = one_hot(labels)`` for a
    class-grouped cache; (B, Nt, C) f32. Correct for any row order (the host
    sorts the rows by class)."""
    nc = cache_features.shape[0]
    labels = _host_labels(cache_labels, nc, num_classes)
    if test_features.device.type == "cpu":
        return cache_attention_labels_reference(
            test_features, cache_features, torch.from_numpy(labels), _betas(betas, "cpu"),
            num_classes)
    return _grouped_launches(cache_attention_onehot, "onehot_grouped", test_features,
                             cache_features, labels, betas, num_classes)


cache_attention_onehot.launches = 0


def _grouped_launches(wrapper, name: str, test_features: torch.Tensor,
                      cache_features: torch.Tensor, labels: np.ndarray, betas: tp.Any,
                      num_classes: int, *extra: int,
                      block_n: tp.Optional[int] = None) -> torch.Tensor:
    """K2's, K3's and K13's launches on CUDA tensors: bf16 features, the
    cache rows gathered into class order, the host tables of
    :func:`grouped_plan`, up to ``K3_MAX_BETA`` betas a launch of
    ``<name>_bf16`` (``extra``: K13's mode), counted on ``wrapper``."""
    nt, d = test_features.shape
    dev = test_features.device
    bet = _betas(betas, dev)
    f, cf, nt_p, _, d_p = _cuda_features(test_features, cache_features, GROUPED_QUERIES)
    lib = _lib_cache()
    if lib.grouped_stages(d_p) == 0:
        raise ValueError(f"K2 / K3 / K13 take D up to what shared memory holds, got {d}")
    plan, order, tables = _grouped_tables(labels, num_classes, nt_p, block_n, dev)
    n_items = plan.items.shape[0] - 1
    cs = cf.index_select(0, order) if n_items else cf      # the rows in class order
    out = torch.empty(bet.shape[0], nt, num_classes, dtype=torch.float32, device=dev)
    ws = torch.empty(max(plan.n_slots, 1) * K3_MAX_BETA * nt_p * 4, dtype=torch.float32,
                     device=dev)
    entry = getattr(lib, f"{name}_bf16")
    stream = _lib.torch_stream()
    for s in range(0, bet.shape[0], K3_MAX_BETA):
        chunk = bet[s:s + K3_MAX_BETA].contiguous()
        view = out[s:s + K3_MAX_BETA]
        _lib.check(entry(f.data_ptr(), cs.data_ptr(), *(t.data_ptr() for t in tables),
                         chunk.data_ptr(), view.data_ptr(), ws.data_ptr(), chunk.shape[0], nt,
                         nt_p, order.shape[0], d_p, num_classes, n_items,
                         plan.fix_cls.shape[0], *extra, stream), name)
        wrapper.launches += 1
    return out


_PLAN_CACHE: list = []   # the last call's (key, labels, tables): a sweep repeats its labels


def _grouped_tables(labels: np.ndarray, num_classes: int, nt_p: int,
                    block_n: tp.Optional[int], dev: torch.device):
    """The plan for these labels on ``dev`` and its tables there: the row
    order (int64) and meta, items, slots, fix_cls, fix_offs (int32, one copy)."""
    n_tiles = -(-int((labels >= 0).sum()) // GROUPED_ROWS)
    n_items = grouped_items(n_tiles, nt_p // GROUPED_QUERIES, _sm_count(dev))
    key = (num_classes, n_items, block_n, str(dev))
    if _PLAN_CACHE and _PLAN_CACHE[0][0] == key and np.array_equal(_PLAN_CACHE[0][1], labels):
        return _PLAN_CACHE[0][2]
    plan = grouped_plan(labels, num_classes, n_items=n_items, block_n=block_n)
    parts = (plan.meta, plan.items, plan.slots.reshape(-1), plan.fix_cls, plan.fix_offs)
    ints = torch.from_numpy(np.concatenate(parts).astype(np.int32)).to(dev)
    tables = torch.split(ints, [p.shape[0] for p in parts])
    out = (plan, torch.from_numpy(plan.order).to(dev), tables)
    _PLAN_CACHE[:] = [(key, labels.copy(), out)]
    return out


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def cache_attention_labels(test_features: torch.Tensor, cache_features: torch.Tensor,
                           cache_labels: tp.Any, betas: tp.Any,
                           num_classes: int) -> torch.Tensor:
    """K2: ``cache_attention`` with ``values = one_hot(labels)`` for any row
    order; (B, Nt, C) f32. On the card it is the class-grouped kernel of K3
    (the host sorts the rows by class), under its own entry point and count."""
    nc = cache_features.shape[0]
    labels = _host_labels(cache_labels, nc, num_classes)
    if test_features.device.type == "cpu":
        return cache_attention_labels_reference(
            test_features, cache_features, torch.from_numpy(labels), _betas(betas, "cpu"),
            num_classes)
    return _grouped_launches(cache_attention_labels, "labels_dense", test_features,
                             cache_features, labels, betas, num_classes)


cache_attention_labels.launches = 0


def cache_attention_from_labels(test_features: torch.Tensor, cache_features: torch.Tensor,
                                cache_labels: tp.Any, betas: tp.Any, num_classes: int, *,
                                k_limit: int = 128) -> torch.Tensor:
    """Label-driven route: K3 when every cache block of the JAX K3 blocking
    spans at most ``k_limit`` classes, K2 otherwise (an explicit test; the
    JAX package catches the ValueError K3 raises)."""
    labels = _host_labels(cache_labels, cache_features.shape[0], num_classes)
    itemsize = 4 if test_features.device.type == "cpu" else 2   # compute dtype: f32 / bf16
    k_max = onehot_k_max(labels, num_classes, test_features.shape[1], itemsize)
    kernel = cache_attention_onehot if k_max <= k_limit else cache_attention_labels
    return kernel(test_features, cache_features, labels, betas, num_classes)


def cache_attention_auto(test_features: torch.Tensor, cache_features: torch.Tensor,
                         cache_values: torch.Tensor, betas: tp.Any,
                         cache_labels: tp.Optional[tp.Any] = None) -> torch.Tensor:
    """(B, Nt, C) cache logits. With ``cache_labels`` (values known to be
    ``one_hot(labels)``) the label-driven kernels run (K3 or K2); without
    them the dense kernel K1."""
    if cache_labels is not None:
        return cache_attention_from_labels(test_features, cache_features, cache_labels,
                                           betas, int(cache_values.shape[1]))
    return cache_attention(test_features, cache_features, cache_values, betas)


def _split3(small: torch.Tensor) -> torch.Tensor:
    """``small`` as the sum ``(hi + mid) + lo`` of its three bf16 parts (exact)."""
    hi = small.to(torch.bfloat16).float()
    r1 = small - hi
    mid = r1.to(torch.bfloat16).float()
    lo = (r1 - mid).to(torch.bfloat16).float()
    return (hi + mid) + lo


def onehot_variant_reference(test_features: torch.Tensor, cache_features: torch.Tensor,
                             cache_labels: tp.Any, betas: tp.Any, num_classes: int, *,
                             block_n: int, expand_mode: str = "split3", cast_w: bool = False,
                             compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version of K13, the TPU tool's blocks done literally; (B, Nt, C) f32.

    Features rounded to ``compute_dtype``, the affinity in f32, ``w =
    exp(-beta (1 - aff))`` rounded to bf16 when ``cast_w`` is set or the
    compute dtype is bf16 (the product then takes a bf16 operand, as the TPU's
    default-precision product does and as the kernel does). Per ``block_n``-row
    block of the cache (rows in their given order, the last block short) the
    class partials ``small = w_block @ local`` are summed in f32 and added to
    the f32 output as ``expand_mode`` says: ``"highest"`` as they are,
    ``"split3"`` as ``(hi + mid) + lo`` of their bf16 parts, ``"default"``
    rounded to bf16. Labels -1 add nothing."""
    if expand_mode not in EXPAND_MODES:
        raise ValueError(f"expand_mode must be one of {EXPAND_MODES}, got {expand_mode!r}")
    nc = cache_features.shape[0]
    labels = torch.from_numpy(_host_labels(cache_labels, nc, num_classes)).long()
    dev = test_features.device
    f = test_features.to(compute_dtype).float()
    c = cache_features.to(device=dev, dtype=compute_dtype).float()
    aff = f @ c.t()
    bet = _betas(betas, "cpu").tolist()
    out = torch.zeros(len(bet), f.shape[0], num_classes, dtype=torch.float32, device=dev)
    blocks = []   # (row slice, classes present, local one-hot (rows, k))
    for n0 in range(0, nc, block_n):
        lab = labels[n0:n0 + block_n]
        classes = torch.unique(lab[lab >= 0])
        if classes.numel():
            local = (lab[:, None] == classes[None]).float().to(dev)
            blocks.append((slice(n0, n0 + block_n), classes.to(dev), local))
    round_w = cast_w or compute_dtype == torch.bfloat16
    for bi, beta in enumerate(bet):
        w = torch.exp(-beta * (1.0 - aff))
        if round_w:
            w = w.to(torch.bfloat16).float()
        for rows, classes, local in blocks:
            small = w[:, rows] @ local
            if expand_mode == "split3":
                small = _split3(small)
            elif expand_mode == "default":
                small = small.to(torch.bfloat16).float()
            out[bi][:, classes] += small
    return out


def onehot_variant(test_features: torch.Tensor, cache_features: torch.Tensor,
                   cache_labels: tp.Any, betas: tp.Any, num_classes: int, *,
                   block_n: int = 1024, expand_mode: str = "split3",
                   cast_w: bool = False) -> torch.Tensor:
    """K13: ``cache_attention`` with ``values = one_hot(labels)``, the class
    partials of each ``block_n``-row cache block added to the output as
    ``expand_mode`` says (see :func:`onehot_variant_reference`); (B, Nt, C)
    f32, up to 16 betas a launch. The weights are bf16 on the card whatever
    ``cast_w`` says (the kernel's note). A CPU tensor takes the plain version
    in bf16."""
    if expand_mode not in EXPAND_MODES:
        raise ValueError(f"expand_mode must be one of {EXPAND_MODES}, got {expand_mode!r}")
    if block_n < 1:
        raise ValueError(f"block_n must be positive, got {block_n}")
    nc = cache_features.shape[0]
    labels = _host_labels(cache_labels, nc, num_classes)
    if test_features.device.type == "cpu":
        return onehot_variant_reference(test_features, cache_features, labels, betas,
                                        num_classes, block_n=block_n, expand_mode=expand_mode,
                                        cast_w=cast_w)
    return _grouped_launches(onehot_variant, "onehot_variant", test_features, cache_features,
                             labels, betas, num_classes, EXPAND_MODES.index(expand_mode),
                             block_n=block_n)


onehot_variant.launches = 0
