"""``methods/cache`` of the port against the JAX package's.

Selection is host-side numpy with seeded generators in both packages, so every
strategy must pick the same rows bit for bit, in the same order; value
strategies must give equal matrices; the weights strategy and
``cache_logits_for_betas`` (f32 on the CPU on both sides) agree to 1e-5.
"""

import numpy as np
import pytest
import torch

from summer_clip_torch.methods import cache as tc

N, C, D = 120, 6, 16


def _data(seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((N, D)).astype(np.float32)
    outs = (rng.standard_normal((N, C)) * 0.3).astype(np.float32)
    labels = rng.integers(0, C, N)
    return feats, outs, labels


STRATEGIES = [
    ("AllLogitsStrategy", {}),
    ("ThresholdStrategy", {"threshold": 0.25}),
    ("ThresholdStrategy", {"threshold": 0.1, "use_softmax": False}),
    ("TopKStrategy", {"topk": 3}),
    ("TopKStrategy", {"topk": 64}),
    ("TopKProbStrategy", {"topk": 4, "scale": 100.0}),
    ("TopKPerGoldStrategy", {"topk": 5, "cache_labels": "labels"}),
    ("TopKPerGoldProbStrategy", {"topk": 2, "cache_labels": "labels", "scale": 100.0}),
    ("GlobalRandomSampleStrategy", {"topk": 2, "seed": 11}),
    ("GlobalRandomSampleStrategy", {"topk": 2}),
    ("PerGoldClassRandomSampleStrategy", {"topk": 3, "cache_labels": "labels", "seed": 12}),
    ("PerGoldClassRandomSampleStrategy", {"topk": 3, "cache_labels": "labels"}),
    ("PerPredClassRandomSampleStrategy", {"topk": 4, "seed": 13}),
    ("PerPredClassRandomSampleStrategy", {"topk": 4}),
]


@pytest.mark.parametrize("name,params", STRATEGIES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(STRATEGIES)])
def test_selection_is_bit_identical(name, params):
    from summer_clip_tpu.methods import cache as jc

    feats, outs, labels = _data()
    params = {k: (labels if v == "labels" else v) for k, v in params.items()}
    picks = []
    for mod in (jc, tc):
        np.random.seed(42)      # the unseeded strategies draw from numpy's global state
        picks.append(np.asarray(getattr(mod, name)(**params).select(feats, outs)))
    want, got = picks
    assert got.dtype == want.dtype and got.shape == want.shape and len(got) > 0
    np.testing.assert_array_equal(got, want)
    strategy = getattr(tc, name)(**params)
    assert isinstance(strategy, tc.IndexedCacheStrategy)
    if "Random" not in name:      # transform is select + gather
        cf, co = strategy.transform(feats, outs)
        np.testing.assert_array_equal(cf, feats[want])
        np.testing.assert_array_equal(co, outs[want])


@pytest.mark.parametrize("helper", ["select_topk_per_label", "select_k_random_per_label"])
def test_selection_helpers_match(helper):
    from summer_clip_tpu.methods import cache as jc

    _, outs, labels = _data(1)
    if helper == "select_topk_per_label":
        args = lambda: (labels, outs.max(1), 4)                       # noqa: E731
    else:
        args = lambda: (labels, 4, np.random.default_rng(5))          # noqa: E731
    np.testing.assert_array_equal(getattr(tc, helper)(*args()), getattr(jc, helper)(*args()))


@pytest.mark.parametrize("name,params", [("HardCacheStrategy", {}),
                                         ("SoftmaxCacheStrategy", {"clip_scale": 100.0,
                                                                   "scale": 0.1})])
def test_value_strategies_match(name, params):
    from summer_clip_tpu.methods import cache as jc

    _, outs, _ = _data(2)
    got = getattr(tc, name)(**params).transform(outs)
    want = getattr(jc, name)(**params).transform(outs)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_weights_strategy_and_fused_logits_match():
    import jax.numpy as jnp  # noqa: F401  (the JAX function needs its backend)

    from summer_clip_tpu.methods import cache as jc

    feats, outs, _ = _data(3)
    test = _data(4)[0][:20]
    betas = [0.1, 1.0, 5.5]
    np.testing.assert_allclose(tc.TipAdapterWeightsStrategy(1.5).transform(test, feats),
                               jc.TipAdapterWeightsStrategy(1.5).transform(test, feats),
                               rtol=1e-6, atol=1e-6)
    for values in (tc.HardCacheStrategy().transform(outs),
                   tc.SoftmaxCacheStrategy(100.0, 0.1).transform(outs)):
        want = np.asarray(jc.cache_logits_for_betas(test, feats, values, betas))
        got = tc.cache_logits_for_betas(test, feats, values, betas, device="cpu")
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        dense = np.stack([tc.TipAdapterWeightsStrategy(b).transform(test, feats)
                          @ values.astype(np.float32) for b in betas])
        np.testing.assert_allclose(got.numpy(), dense, rtol=1e-5, atol=1e-5)
    hard = tc.HardCacheStrategy().transform(outs)
    by_labels = tc.cache_logits_for_betas(test, feats, hard, betas,
                                          cache_labels=outs.argmax(1), device="cpu")
    np.testing.assert_allclose(by_labels.numpy(),
                               tc.cache_logits_for_betas(test, feats, hard, betas, device="cpu").numpy(),
                               rtol=1e-5, atol=1e-5)


def test_conf_targets_resolve_into_the_port():
    """Every strategy yaml of the port's conf/ instantiates a class of the
    port's methods/cache (grid lists expand as in the JAX package)."""
    from pathlib import Path

    import yaml

    from summer_clip_torch.core import config as C

    conf = Path(tc.__file__).resolve().parent.parent / "conf"
    seen = set()
    for group in ("cache_strategy", "cache_value_strategy", "cache_weights_strategy"):
        for path in sorted((conf / group).glob("*.yaml")):
            node = yaml.safe_load(path.read_text())
            assert node["_target_"].startswith("summer_clip_torch.methods.cache.")
            if "cache_labels" in node:
                node["cache_labels"] = [0, 1, 2]
            for obj, params in C.instantiate_all(node):
                assert type(obj).__module__ == "summer_clip_torch.methods.cache"
                seen.add(type(obj).__name__)
    assert len(seen) == 9 + 2 + 1
