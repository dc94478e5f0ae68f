"""Host tables of the class-grouped kernel (K2, K3, K13) on the CPU.

``grouped_plan`` orders the cache rows by class, marks where classes and K13's
segments begin, cuts the sorted rows into work items and gives each class that
an item boundary cuts its workspace slots. The kernel runs only on a card, so
these tests walk the tables in numpy exactly as ``grouped_kernel`` and
``grouped_fix_kernel`` do (rows in order, a class's pieces as (h, c, o, s)
records, the records added in item order) over a seeded dense weight matrix,
and hold the sums to the plain versions (``cache_attention_labels_reference``,
``onehot_variant_reference``) on the same f32 weights: the same terms in
another f32 order, 1e-5 relative. K13's ``default`` mode rounds each segment's
sum to bf16 once: against the plain version's per-block rounding of the same
terms summed in another order it may land one bf16 step (2^-7 of the
partial's binade) away.
"""

import numpy as np
import pytest
import torch

from summer_clip_torch.ops import cache_kernels as ck

R = ck.GROUPED_ROWS
NT, D = 12, 16
CLS_START, SEG_START, CLS_MASK = -(1 << 31), 1 << 30, (1 << 30) - 1


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _expand(mode):
    if mode == "default":
        return _bf16
    if mode == "split3":
        def split3(p):
            hi = _bf16(p)
            mid = _bf16(p - hi)
            lo = _bf16(p - hi - mid)
            return (hi + mid) + lo
        return split3
    return lambda p: p


def _walk(w, plan, num_classes, mode="highest"):
    """The kernel's sums of ``w`` (B, Nt, Nc) f32 by ``plan``, in numpy: each
    item walks its tiles' rows in order (closing a segment or class where
    meta says one begins), writes the classes it holds whole and a piece
    record for a class cut at its ends; the second pass adds the records in
    item order and writes the cut and the empty classes."""
    expand = _expand(mode)
    nb, nt, _ = w.shape
    ws_sorted = w[:, :, plan.order]
    out = np.full((nb, nt, num_classes), np.nan, np.float32)
    ws = np.zeros((plan.n_slots, nb, nt, 4), np.float32)
    meta = plan.meta.astype(np.int64)
    for item in range(plan.items.shape[0] - 1):
        head, tail = plan.slots[item]
        r0, r1 = plan.items[item] * R, plan.items[item + 1] * R
        m0 = meta[r0]
        cur = CLS_MASK if m0 < 0 else m0 & CLS_MASK
        in_head, seen = m0 >= 0, False
        zero = np.zeros((nb, nt), np.float32)
        open_, cacc, hfirst = zero.copy(), zero.copy(), zero.copy()

        def close_class():
            if cur != CLS_MASK:
                last = expand(open_)
                if in_head:
                    ws[head] = (np.stack([hfirst, cacc + last, zero, zero + 1], -1) if seen
                                else np.stack([open_, zero, zero, zero], -1))
                else:
                    out[:, :, cur] = cacc + last
            return zero.copy(), zero.copy()

        for r in range(r0, r1):
            m = meta[r]
            if m < 0:
                open_, cacc = close_class()
                cur, in_head = m & CLS_MASK, False
            elif m & SEG_START:
                if in_head and not seen:
                    hfirst = open_
                else:
                    cacc = cacc + expand(open_)
                open_ = zero.copy()
                seen = seen or in_head
            open_ = open_ + ws_sorted[:, :, r]
        if tail >= 0:
            rec = ([zero, cacc, open_, zero + 1] if not in_head
                   else [hfirst, cacc, open_, zero + 1] if seen else [open_, zero, zero, zero])
            ws[tail] = np.stack(rec, -1)
        else:
            close_class()
    for e, c in enumerate(plan.fix_cls):
        cacc, open_ = np.zeros((nb, nt), np.float32), np.zeros((nb, nt), np.float32)
        for s in range(plan.fix_offs[e], plan.fix_offs[e + 1]):
            h, cc, o, sflag = np.moveaxis(ws[s], -1, 0)
            open_ = open_ + h
            closed = sflag != 0
            cacc = np.where(closed, cacc + expand(open_), cacc)
            open_ = np.where(closed, 0, open_).astype(np.float32)
            cacc = cacc + cc
            open_ = open_ + o
        out[:, :, c] = cacc + expand(open_)
    return out


def _inputs(seed, nc):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((NT + nc, D)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    f, keys = torch.from_numpy(a[:NT]), torch.from_numpy(a[NT:])
    betas = torch.tensor([0.5, 3.0, 6.9])
    w = torch.stack([torch.exp(-b * (1.0 - f @ keys.t())) for b in betas.tolist()]).numpy()
    return f, keys, betas, w


def _labels(case, rng):
    if case == "grouped":
        return np.repeat(np.arange(10, dtype=np.int32), 37), 10
    if case == "shuffled":
        lab = np.repeat(np.arange(10, dtype=np.int32), 37)
        return lab[rng.permutation(lab.shape[0])], 10
    if case == "one_class_90":      # a search cache collapsed onto one class
        return np.sort(rng.choice([3, 11, 17], 400, p=[0.9, 0.07, 0.03])).astype(np.int32), 20
    if case == "empty_and_padding":  # classes 0, 4, 9 have no rows; -1 rows add nothing
        lab = rng.choice([1, 2, 3, 5, 6, 7, 8, -1], 300).astype(np.int32)
        return lab, 10
    if case == "one_row_classes":   # every row its own class
        return rng.permutation(260).astype(np.int32), 270
    raise ValueError(case)


CASES = ["grouped", "shuffled", "one_class_90", "empty_and_padding", "one_row_classes"]


@pytest.mark.parametrize("n_items", [1, 3, 7])
@pytest.mark.parametrize("case", CASES)
def test_grouped_sums_match_plain(case, n_items):
    rng = np.random.default_rng(CASES.index(case))
    labels, c = _labels(case, rng)
    f, keys, betas, w = _inputs(1, labels.shape[0])
    plan = ck.grouped_plan(labels, c, n_items=n_items)
    got = _walk(w, plan, c)
    want = ck.cache_attention_labels_reference(f, keys, torch.from_numpy(labels), betas, c).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if n_items > 1 and case in ("grouped", "one_class_90"):
        assert plan.n_slots > 0, "no class is cut: the cut path is not tested"


@pytest.mark.parametrize("mode", ck.EXPAND_MODES)
@pytest.mark.parametrize("block_n,n_items", [(64, 1), (64, 5), (48, 4), (1000, 3)])
def test_k13_segments_match_plain(mode, block_n, n_items):
    """Classes whose rows cross block_n blocks (several segments a class),
    classes and segments cut by item boundaries, a padded last tile."""
    rng = np.random.default_rng(2)
    labels = np.sort(rng.integers(0, 9, 700)).astype(np.int32)
    labels[rng.choice(700, 20, replace=False)] = -1
    f, keys, betas, w = _inputs(3, labels.shape[0])
    plan = ck.grouped_plan(labels, 10, n_items=n_items, block_n=block_n)
    got = _walk(w, plan, 10, mode)
    want = ck.onehot_variant_reference(f, keys, labels, betas, 10, block_n=block_n,
                                       expand_mode=mode, compute_dtype=torch.float32).numpy()
    step = 2.0 ** -7 * np.abs(want) if mode == "default" else 0.0
    assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want) + step + 1e-6)
    if mode != "default":
        np.testing.assert_array_equal(got, _walk(w, plan, 10, "split3" if mode == "highest"
                                                 else "highest"))


@pytest.mark.parametrize("block_n", [32, 100, 256])
def test_k13_segments_are_the_jax_blocks(block_n):
    """The (block, class) runs the plan marks are the JAX kernel's per-block
    class table (``onehot_block_classes``)."""
    from summer_clip_tpu.ops import cache_kernels as jck

    rng = np.random.default_rng(block_n)
    labels = rng.integers(-1, 12, 600).astype(np.int32)
    plan = ck.grouped_plan(labels, 12, block_n=block_n)
    real = plan.meta[: int((labels >= 0).sum())].astype(np.int64)
    starts = np.flatnonzero(real & SEG_START)
    rows = plan.order[: real.shape[0]]
    got = {(int(rows[s] // block_n), int(real[s] & CLS_MASK)) for s in starts}
    assert len(got) == starts.shape[0]       # one segment per (block, class)
    padded = np.full((-(-labels.shape[0] // block_n) * block_n,), -1, np.int32)
    padded[: labels.shape[0]] = labels
    table, _ = jck.onehot_block_classes(padded, block_n)
    want = {(blk, int(c)) for blk, row in enumerate(np.asarray(table)) for c in row if c >= 0}
    assert got == want


@pytest.mark.parametrize("case", CASES)
def test_plan_invariants(case):
    labels, c = _labels(case, np.random.default_rng(5))
    plan = ck.grouped_plan(labels, c, n_items=4)
    real = np.flatnonzero(labels >= 0)
    n_tiles = -(-real.shape[0] // R)
    assert plan.order.shape == plan.meta.shape == (n_tiles * R,)
    np.testing.assert_array_equal(np.sort(plan.order[: real.shape[0]]), real)
    sizes = np.diff(plan.items)
    assert plan.items[0] == 0 and plan.items[-1] == n_tiles and sizes.max() - sizes.min() <= 1
    meta = plan.meta.astype(np.int64)
    for i, (head, tail) in enumerate(plan.slots):
        first, last = plan.items[i] * R, plan.items[i + 1] * R - 1
        assert (head >= 0) == (meta[first] >= 0)          # begins inside a class
        ends_inside = last + 1 < real.shape[0] and meta[last + 1] >= 0
        assert (tail >= 0) == ends_inside
    counts = np.bincount(labels[labels >= 0], minlength=c)
    cut = set(plan.fix_cls.tolist()) - set(np.flatnonzero(counts == 0).tolist())
    assert set(np.flatnonzero(counts == 0)) <= set(plan.fix_cls.tolist())
    assert len(cut) <= plan.items.shape[0] - 2        # an item boundary cuts one class at most
    assert plan.fix_offs[-1] == plan.n_slots


def test_grouped_items():
    # the query tiles alone fill the card: one item; few query tiles: several
    assert ck.grouped_items(250, 784, 132) == 1
    assert ck.grouped_items(250, 128, 132) == 1
    assert 4 <= ck.grouped_items(32, 16, 132) <= 16
    assert ck.grouped_items(1, 4, 132) == 1 and ck.grouped_items(0, 4, 132) == 0
    plan = ck.grouped_plan(np.full(5, -1, np.int32), 3)   # no real row: only the fix pass
    assert plan.items.shape == (1,) and plan.fix_cls.tolist() == [0, 1, 2]
