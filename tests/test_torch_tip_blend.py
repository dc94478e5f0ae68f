"""K14 (``ops/cache_kernels.blend_argmax_hits``): the Tip search's blend,
argmax and hit count, and ``methods/tip.search_hp`` around it.

The plain version is held against the expression ``search_hp`` used before
(each beta's blend written whole, ``argmax``, mean) and against a numpy oracle
(float32 blend, ``np.argmax``: the first maximum, the first NaN) at ragged
shapes with planted ties. Inputs built so that every alpha of every beta has
its own known count show that no (beta, alpha) is left out or repeated, in the
op and in the search. The ``cuda`` tests hold the kernel to the plain version
bit for bit on a card and skip without one. ``search_hp`` against the JAX
package: ``tests/test_torch_clip.py::test_search_hp_and_tip_logits_match_jax``.
"""

import numpy as np
import pytest
import torch

from summer_clip_torch.methods import tip
from summer_clip_torch.ops import cache_kernels as ck

ALPHAS = np.asarray(tip.beta_alpha_grid((7, 3), (1, 20))[1], np.float32)


def _alphas(a):
    return np.concatenate([ALPHAS[:a - 1], [1.0]]).astype(np.float32)   # 1.0: exact products


def _problem(seed, nb, nt, c, a):
    """Half the rows random f32 (rounding matters), half on a 0.5 grid with
    alpha 1.0 among the alphas, so duplicate maxima and products that cancel
    against the zero-shot logits tie exactly; labels half at the first of a
    row's tied maxima (at alpha 1.0) and half at its last."""
    rng = np.random.default_rng(seed)
    cl = rng.standard_normal((nt, c)).astype(np.float32) * 3
    cache = rng.random((nb, nt, c)).astype(np.float32)
    grid = nt // 2
    cl[:grid] = rng.integers(0, 4, (grid, c)) * 0.5
    cache[:, :grid] = rng.integers(0, 3, (nb, grid, c)) * 0.5
    alphas = _alphas(a)
    at_one = cl[None] + cache      # the blend at alpha 1.0, exact on the grid rows
    top = at_one.max(-1, keepdims=True)
    first = np.argmax(at_one[0], -1)
    last = c - 1 - np.argmax(at_one[0][:, ::-1] == top[0], -1)
    labels = np.where(np.arange(nt) % 2 == 0, first, last).astype(np.int64)
    labels[grid:] = rng.integers(0, c, nt - grid)
    return cache, cl, labels, alphas


def _oracle(cache, cl, labels, alphas):
    blend = cl[None, None] + alphas[None, :, None, None] * cache[:, None]   # (B, A, Nt, C) f32
    return (np.argmax(blend, -1) == labels).sum(-1).astype(np.int32)


def _torch(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in arrays)


@pytest.mark.parametrize("c", [10, 101, 1000])
@pytest.mark.parametrize("a", [1, 7, 20])
def test_reference_is_the_old_expression_and_the_first_maximum(c, a):
    """Nt = 45 (not a multiple of 32); C from 10 to 1000; A = 1, 7, 20."""
    cache, cl, labels, alphas = _problem(c + a, 3, 45, c, a)
    t_cache, t_cl, t_y, t_al = _torch(cache, cl, labels, alphas)
    hits = ck.blend_argmax_hits_reference(t_cache, t_cl, t_y, t_al)
    assert hits.dtype == torch.int32 and hits.shape == (3, a)
    np.testing.assert_array_equal(hits.numpy(), _oracle(cache, cl, labels, alphas))
    old = torch.stack([((t_cl[None] + t_al[:, None, None] * x[None]).argmax(-1) == t_y[None])
                       .float().mean(-1) * 100.0 for x in t_cache])
    torch.testing.assert_close(hits.float() / 45 * 100.0, old, rtol=0, atol=1e-4)
    # the CPU wrapper is the plain version
    assert torch.equal(ck.blend_argmax_hits(t_cache, t_cl, t_y, t_al), hits)


def test_ties_go_to_the_lowest_index():
    """Duplicate maxima and a product cancelling against the zero-shot logits:
    the first of the tied columns is the prediction at every alpha."""
    cl = torch.tensor([[1.0, 2.0, 2.0, 0.0], [1.5, 1.0, 0.0, 1.5], [1.0, 1.5, 0.0, 1.5]])
    cache = torch.tensor([[[0.0, 0.0, 0.0, 0.0], [0.0, 0.5, 0.0, 0.0], [0.5, 0.0, 0.0, 0.0]]])
    alphas = torch.tensor([1.0])     # blends: [1, 2, 2, 0], [1.5, 1.5, 0, 1.5], [1.5, 1.5, 0, 1.5]
    for labels, want in (([1, 0, 0], 3), ([2, 1, 3], 0), ([1, 3, 1], 1)):
        got = ck.blend_argmax_hits(cache, cl, torch.tensor(labels), alphas)
        assert got.tolist() == [[want]]


def test_nan_is_the_maximum_and_the_first_nan_wins():
    cl = torch.tensor([[0.0, 1.0, float("nan"), 5.0, float("nan")],
                       [float("inf"), 0.0, 0.0, float("inf"), 0.0],
                       [float("-inf")] * 5])
    cache = torch.zeros(1, 3, 5)
    cache[0, 1, 1] = float("-inf")
    alphas = torch.tensor([0.5, 2.0])
    want = _oracle(cache.numpy(), cl.numpy(), np.asarray([2, 0, 0]), alphas.numpy())
    got = ck.blend_argmax_hits(cache, cl, torch.tensor([2, 0, 0]), alphas)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [[3, 3]]


def _counted(nb, nt, a):
    """Two classes, label 0 everywhere; class 0's blend is alpha (1 + b), class
    1's a threshold t_n: row n hits where alpha (1 + b) >= t_n (a tie goes to
    class 0). The thresholds are finer than the products' gaps, so the count
    of (b, a), the thresholds at or below its product, differs from every
    other alpha's of the beta and every other beta's of the alpha."""
    alphas = ALPHAS[:a]
    prods = (alphas[None] * (1 + np.arange(nb, dtype=np.float32))[:, None]).astype(np.float32)
    t = np.linspace(0.0, float(prods.max()) + 1.0, nt, dtype=np.float32)
    cl = np.stack([np.zeros(nt, np.float32), t], 1)
    cache = np.zeros((nb, nt, 2), np.float32)
    cache[:, :, 0] = (1 + np.arange(nb, dtype=np.float32))[:, None]
    want = (t[None, None] <= prods[..., None]).sum(-1).astype(np.int32)
    return cache, cl, np.zeros(nt, np.int64), alphas, want


@pytest.mark.parametrize("nb,nt,a", [(1, 301, 20), (5, 997, 7), (16, 2003, 20)])
def test_every_beta_and_alpha_has_its_own_count(nb, nt, a):
    """An alpha or a beta left out, repeated or swapped changes the counts."""
    cache, cl, labels, alphas, want = _counted(nb, nt, a)
    assert all(len(set(r)) == a for r in want.tolist())            # a beta's counts differ
    assert all(len(set(r)) == nb for r in want.T.tolist())         # and an alpha's
    got = ck.blend_argmax_hits(*_torch(cache, cl, labels, alphas))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def search_inputs():
    rng = np.random.default_rng(7)
    n, nk, d, c = 60, 24, 16, 6
    unit = lambda x: (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)  # noqa
    feats = unit(rng.standard_normal((n, d)))
    labels = rng.integers(0, c, n)
    key_labels = np.repeat(np.arange(c), nk // c).astype(np.int32)
    keys = unit(rng.standard_normal((nk, d)) + 2 * np.eye(c, d)[key_labels])
    values = np.eye(c, dtype=np.float32)[key_labels]
    cl = (20 * feats @ unit(rng.standard_normal((c, d)) + 2 * np.eye(c, d)).T).astype(np.float32)
    return feats, labels, cl, keys, values, key_labels


@pytest.mark.parametrize("cache_labels", [False, True])
def test_search_hp_blends_every_point_of_the_grid(search_inputs, monkeypatch, cache_labels):
    """Every chunk's hits cover its betas x all alphas, the accuracies the
    search chose from are theirs, and the returned point is the grid's first
    maximum (the plain blend of the same cache logits, point by point)."""
    feats, labels, cl, keys, values, key_labels = search_inputs
    seen = []

    def recording(cache, clip_logits, y, alphas):
        hits = ck.blend_argmax_hits(cache, clip_logits, y, alphas)
        seen.append((cache.clone(), torch.as_tensor(alphas).clone(), hits))
        return hits

    monkeypatch.setattr(tip, "blend_argmax_hits", recording)
    logged = []
    beta, alpha, acc = tip.search_hp(feats, labels, cl, keys, values, search_step=(11, 5),
                                     beta_chunk=4, log_fn=logged.append, device="cpu",
                                     cache_labels=key_labels if cache_labels else None)
    betas, alphas = tip.beta_alpha_grid((7, 3), (11, 5))
    assert [h.shape for _, _, h in seen] == [(4, 5), (4, 5), (3, 5)]
    assert all(np.array_equal(al.numpy(), alphas) for _, al, _ in seen)
    y = torch.as_tensor(labels)
    grid = []
    for cache, al, hits in seen:
        for b in range(cache.shape[0]):
            for ai, a in enumerate(al.tolist()):
                preds = (torch.from_numpy(cl) + a * cache[b]).argmax(-1)
                assert int(hits[b, ai]) == int((preds == y).sum())
        grid.append((hits.float() / len(labels) * 100.0).numpy())
    grid = np.concatenate(grid)
    bi, ai = np.unravel_index(np.argmax(grid), grid.shape)
    assert (beta, alpha, acc) == (float(betas[bi]), float(alphas[ai]), float(grid[bi, ai]))
    assert logged[-1] == {"type": "tip_hp", "beta": beta, "alpha": alpha, "acc": acc}


def test_wrapper_checks_its_inputs_before_any_launch():
    meta = lambda *s, dtype=torch.float32: torch.empty(*s, dtype=dtype, device="meta")  # noqa
    before = ck.blend_argmax_hits.launches
    for args in ((meta(2, 5, 3), meta(5, 4), meta(5, dtype=torch.int64), meta(3)),
                 (meta(2, 5, 3), meta(5, 3), meta(5, dtype=torch.int32), meta(3)),
                 (meta(2, 5, 3, dtype=torch.bfloat16), meta(5, 3), meta(5, dtype=torch.int64),
                  meta(3)),
                 (meta(5, 3), meta(5, 3), meta(5, dtype=torch.int64), meta(3))):
        with pytest.raises(ValueError):
            ck.blend_argmax_hits(*args)
    assert ck.blend_argmax_hits.launches == before


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


def _on_card(*arrays):
    return tuple(t.cuda() for t in _torch(*arrays))


@pytest.mark.cuda
@pytest.mark.parametrize("nb,nt,c,a", [(3, 45, 10, 1), (3, 45, 101, 7), (3, 45, 1000, 20),
                                       (2, 77, 1030, 20), (2, 70, 2500, 30), (5, 33, 64, 50),
                                       (600, 40, 12, 3)])
def test_cuda_kernel_counts_equal_the_plain_version(nb, nt, c, a):
    """The CPU test's shapes and ties, C past one 1024-column slice (aligned
    and not), more alphas and more betas than one launch takes."""
    _cuda()
    cache, cl, labels, _ = _problem(nb * c, nb, nt, c, min(a, 20))
    alphas = np.concatenate([np.linspace(0.1, 3.0, a - 1), [1.0]]).astype(np.float32)
    args = _on_card(cache, cl, labels, alphas)
    before = ck.blend_argmax_hits.launches
    got = ck.blend_argmax_hits(*args)
    again = ck.blend_argmax_hits(*args)
    torch.cuda.synchronize()
    want = ck.blend_argmax_hits_reference(*args)
    assert torch.equal(got, want) and torch.equal(again, got)
    per_call = -(-nb // ck.BLEND_MAX_BETAS) * -(-a // ck.BLEND_MAX_ALPHAS)
    assert ck.blend_argmax_hits.launches == before + 2 * per_call


@pytest.mark.cuda
def test_cuda_kernel_takes_nan_and_inf_as_torch_argmax():
    _cuda()
    cache, cl, labels, alphas = _problem(3, 4, 64, 300, 20)
    cl[3, [5, 200]] = np.nan
    cl[4, 7] = np.inf
    cl[5, [9, 250]] = np.inf
    cache[1, 6, [3, 290]] = np.nan
    cache[2, 8, 100] = -np.inf
    cl[8, 100] = np.inf      # inf - inf: NaN at every alpha
    args = _on_card(cache, cl, labels, alphas)
    assert torch.equal(ck.blend_argmax_hits(*args), ck.blend_argmax_hits_reference(*args))
    bad = args[3].clone()
    bad[4] = float("inf")    # an alpha that is not finite
    assert torch.equal(ck.blend_argmax_hits(*args[:3], bad),
                       ck.blend_argmax_hits_reference(*args[:3], bad))


@pytest.mark.cuda
def test_cuda_kernel_at_the_tip_cell_shape():
    """A Tip chunk: 16 betas x 50,000 rows x 1,000 classes x 20 alphas; the
    built counts of every (beta, alpha) and random logits, bit for bit."""
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(11)
    cl = torch.randn(50000, 1000, device="cuda", generator=gen) * 4
    cache = torch.rand(16, 50000, 1000, device="cuda", generator=gen)
    labels = torch.randint(0, 1000, (50000,), device="cuda", generator=gen)
    alphas = torch.from_numpy(ALPHAS).cuda()
    got = ck.blend_argmax_hits(cache, cl, labels, alphas)
    want = torch.stack([ck.blend_argmax_hits_reference(cache[b:b + 1], cl, labels, alphas)[0]
                        for b in range(16)])
    assert torch.equal(got, want) and torch.equal(ck.blend_argmax_hits(cache, cl, labels, alphas),
                                                  got)
    del cache
    cache, cl, labels, alphas, want = _counted(16, 50000, 20)
    np.testing.assert_array_equal(
        ck.blend_argmax_hits(*_on_card(cache, cl, labels, alphas)).cpu().numpy(), want)


@pytest.mark.cuda
def test_cuda_never_takes_the_plain_route(monkeypatch):
    _cuda()

    def plain(*args):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(ck, "blend_argmax_hits_reference", plain)
    cache, cl, labels, alphas = _problem(1, 2, 40, 50, 7)
    assert ck.blend_argmax_hits(*_on_card(cache, cl, labels, alphas)).shape == (2, 7)


@pytest.mark.cuda
def test_cuda_search_hp_launches_a_chunk_and_equals_the_plain_blend(search_inputs, monkeypatch):
    """One K14 launch a chunk; the same triple and log as ``search_hp`` with
    the plain blend over the same cache logits on the card."""
    _cuda()
    feats, labels, cl, keys, values, key_labels = search_inputs
    kw = dict(search_step=(50, 20), beta_chunk=16, cache_labels=key_labels, device="cuda")
    got_log, want_log = [], []
    before = ck.blend_argmax_hits.launches
    got = tip.search_hp(feats, labels, cl, keys, values, log_fn=got_log.append, **kw)
    assert ck.blend_argmax_hits.launches == before + 4
    monkeypatch.setattr(tip, "blend_argmax_hits", ck.blend_argmax_hits_reference)
    want = tip.search_hp(feats, labels, cl, keys, values, log_fn=want_log.append, **kw)
    assert ck.blend_argmax_hits.launches == before + 4
    assert got == want and got_log == want_log
