"""K2 and K3 (label-driven cache attention) of the port against the JAX kernels.

The JAX side runs ``cache_attention_onehot`` / ``cache_attention_labels`` in
Pallas interpret mode (f32 compute on the CPU); the port side runs the
wrappers on CPU tensors, i.e. the plain version. Same numpy inputs; f32 sums
of the same terms in another order hold to 1e-5. The ``cuda`` test compares
the CUDA kernels with the plain version on a card and skips without one.
"""

import numpy as np
import pytest
import torch

from summer_clip_torch.ops import cache_kernels as ck

NT, D, C = 20, 32, 7


def _unit(rng, n, d=D):
    a = rng.standard_normal((n, d)).astype(np.float32)
    return a / np.linalg.norm(a, axis=1, keepdims=True)


def _cache(rng, grouped: bool):
    labels = np.repeat(np.arange(C, dtype=np.int32), 6)            # 42 rows, class-grouped
    labels = np.concatenate([labels, [-1, -1, -1]]).astype(np.int32)  # pad rows add nothing
    if not grouped:
        labels = labels[rng.permutation(labels.shape[0])]
    return _unit(rng, labels.shape[0]), labels


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("kernel", ["onehot", "labels"])
def test_label_kernels_match_jax(kernel, grouped):
    import jax.numpy as jnp

    from summer_clip_tpu.ops import cache_kernels as jck

    rng = np.random.default_rng(7)
    f = _unit(rng, NT)
    keys, labels = _cache(rng, grouped)
    betas = np.asarray([0.5, 3.0, 6.9], np.float32)
    jax_fn = {"onehot": jck.cache_attention_onehot, "labels": jck.cache_attention_labels}[kernel]
    port_fn = {"onehot": ck.cache_attention_onehot, "labels": ck.cache_attention_labels}[kernel]
    want = np.asarray(jax_fn(jnp.asarray(f), jnp.asarray(keys), labels, jnp.asarray(betas), C,
                             interpret=True))
    got = port_fn(torch.from_numpy(f), torch.from_numpy(keys), labels, torch.from_numpy(betas),
                  C).numpy()
    assert got.shape == (3, NT, C)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_plain_label_version_equals_dense_oracle():
    from summer_clip_tpu.ops.cache_kernels import cache_attention_reference

    rng = np.random.default_rng(8)
    f = _unit(rng, NT)
    keys, labels = _cache(rng, grouped=False)
    values = np.zeros((labels.shape[0], C), np.float32)
    values[labels >= 0, labels[labels >= 0]] = 1.0
    betas = np.asarray([1.0, 5.5], np.float32)
    want = np.asarray(cache_attention_reference(f, keys, values, betas))
    for got in (ck.cache_attention_auto(torch.from_numpy(f), torch.from_numpy(keys),
                                        torch.from_numpy(values), betas),
                ck.cache_attention_auto(torch.from_numpy(f), torch.from_numpy(keys),
                                        torch.from_numpy(values), betas, cache_labels=labels)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n_classes,shots,shuffle", [(1000, 16, False), (1000, 1, False),
                                                     (200, 4, True), (7, 6, True)])
def test_route_k_max_matches_jax_blocking(n_classes, shots, shuffle, itemsize):
    """The K3/K2 route is decided on the JAX package's K3 blocking."""
    from summer_clip_tpu.ops import cache_kernels as jck

    labels = np.repeat(np.arange(n_classes, dtype=np.int32), shots)
    if shuffle:
        labels = labels[np.random.default_rng(0).permutation(labels.shape[0])]
    d = 512
    d_p, c_p = 512, -(-max(n_classes, 128) // 128) * 128
    _, bn, _ = jck._pick_blocks_onehot(d_p, c_p, itemsize)
    padded = np.full((-(-labels.shape[0] // bn) * bn,), -1, np.int32)
    padded[: labels.shape[0]] = labels
    want = jck.onehot_block_classes(padded, bn)
    assert ck.onehot_k_max(labels, n_classes, d, itemsize) == want[1]
    np.testing.assert_array_equal(ck.onehot_block_classes(padded, bn)[0], want[0])


@pytest.mark.parametrize("shots,want", [(16, "onehot"), (1, "labels")])
def test_from_labels_routes_by_explicit_test(monkeypatch, shots, want):
    called = []
    for name in ("cache_attention_onehot", "cache_attention_labels"):
        monkeypatch.setattr(ck, name, lambda *a, _n=name: called.append(_n))
    labels = np.repeat(np.arange(1000, dtype=np.int32), shots)
    f = torch.zeros(2, 512)
    ck.cache_attention_from_labels(f, torch.zeros(labels.shape[0], 512), labels, [1.0], 1000)
    assert called == [f"cache_attention_{want}"]


def test_class_row_table():
    labels = np.asarray([2, -1, 0, 2, 1, 0, -1, 2], np.int32)
    rows, offs = ck.class_row_table(labels, 4)
    np.testing.assert_array_equal(rows, [2, 5, 4, 0, 3, 7])
    np.testing.assert_array_equal(offs, [0, 2, 3, 6, 6])


def test_bad_labels_and_dense_k1_raise():
    f = torch.zeros(3, D)
    with pytest.raises(ValueError, match="out of range"):
        ck.cache_attention_onehot(f, torch.zeros(4, D), [0, 1, 7, 0], [1.0], 7)
    with pytest.raises(ValueError, match="rows"):
        ck.cache_attention_labels(f, torch.zeros(4, D), [0, 1], [1.0], 7)
    meta = torch.empty(3, D, device="meta")
    with pytest.raises(ValueError, match="CUDA"):      # K1 launches or raises, too
        ck.cache_attention_auto(meta, torch.empty(4, D, device="meta"),
                                torch.empty(4, 7, device="meta"), [1.0])
    with pytest.raises(ValueError, match="CUDA"):
        ck.cache_attention_onehot(meta, torch.empty(4, D, device="meta"), [0, 1, 2, 3], [1.0], 7)
    assert ck.cache_attention_onehot.launches == 0 and ck.cache_attention_labels.launches == 0
    assert ck.cache_attention.launches == 0


@pytest.mark.cuda
def test_cuda_k3_k2_match_plain(monkeypatch):
    """On the card: K3 and K2 against the plain version (a weight may round to
    the neighbouring bf16 value: 2e-2) and each other (the same weights, other
    f32 orders: 1e-4), on class-grouped, shuffled and one-class (90%) labels,
    with the sorted rows in 1, 3 and 7 work items (classes cut by an item
    boundary); two runs equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    rng = np.random.default_rng(9)
    f = torch.from_numpy(_unit(rng, 200, 512)).cuda()
    betas = torch.linspace(0.1, 6.9, 20).cuda()
    cases = {"grouped": np.repeat(np.arange(40, dtype=np.int32), 5),
             "one_class_90": np.sort(rng.choice([3, 17, 31], 900, p=[0.9, 0.07, 0.03])
                                     ).astype(np.int32)}
    cases["shuffled"] = cases["grouped"][rng.permutation(200)]
    for name, labels in cases.items():
        keys = torch.from_numpy(_unit(rng, labels.shape[0], 512)).cuda()
        want = ck.cache_attention_labels_reference(f, keys, torch.from_numpy(labels), betas, 40,
                                                   compute_dtype=torch.bfloat16)
        for items in (1, 3, 7):
            monkeypatch.setattr(ck, "grouped_items", lambda *a, _n=items, **k: _n)
            k3, k3_again = (ck.cache_attention_onehot(f, keys, labels, betas, 40) for _ in "ab")
            k2 = ck.cache_attention_labels(f, keys, labels, betas, 40)
            torch.cuda.synchronize()
            assert (k3 - want).abs().max() <= 2e-2 and (k2 - want).abs().max() <= 2e-2, name
            assert (k3 - k2).abs().max() <= 1e-4, name
            assert torch.equal(k3, k3_again), name
