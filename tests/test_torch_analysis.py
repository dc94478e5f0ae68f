"""The analysis methods and apps of the port against the JAX package.

``methods.linalg`` (``maha_logits``, ``PCA``) and ``methods.em``
(``FixedMeansGMM``, full and diagonal covariances, a few EM steps) on the same
numpy inputs, f32 on both sides: the inverse of the scatter matrix and the
Cholesky factors are the two libraries' own, so results agree to a relative
1e-4 (1e-3 for the full-covariance log-densities, whose ~100 terms each carry
a triangular solve). A PCA component may come out negated: the test aligns
signs before comparing.

Then ``class_projector``, ``maha_distance`` and ``train_em`` of both packages
run once each over one feature store and their accuracy records agree. The
store's image features come from a seeded numpy generator (the synthetic
images are drawn from ``hash(impath)``, which changes with the process's hash
seed), so both apps read the same data in every process; the text features come
from a ``test-vit`` checkpoint that both packages load. ``maha_distance``'s
logits are held to each other too: the f32 inverse of the 32 x 32 scatter
matrix (36 rows, condition number 2e4 to 4e4) magnifies the last-bit
differences of its inputs (the two text towers' features differ by ~2e-7) and
of the two libraries' inverses to at most 2e-4 of max |logit| over 64 hash
seeds of a store written by ``save_features`` (1e-5 on this one); the test
allows 1e-3. On such a store a top-1 margin came down to 2e-3 (2e-5 of max
|logit|), so one test row's argmax could flip between the packages.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from summer_clip_torch.methods import em, linalg


def _records(run_root: Path, kind=None):
    recs = []
    for p in run_root.rglob("records.jsonl"):
        recs.extend(map(json.loads, p.read_text().splitlines()))
    return [r for r in recs if kind is None or r.get("type") == kind]


def _mixture(seed=0, n_per=60, d=5, k=3):
    rng = np.random.RandomState(seed)
    means = (3.0 * rng.randn(k, d)).astype(np.float32)
    x = np.concatenate([rng.randn(n_per, d).astype(np.float32) * (0.5 + i) + means[i]
                        for i in range(k)])
    return x, means


def test_maha_logits_match_jax():
    from summer_clip_tpu.methods import linalg as jl

    rng = np.random.RandomState(0)
    x, t, cache = (rng.randn(n, 8).astype(np.float32) for n in (12, 5, 40))
    want = np.asarray(jl.maha_logits(x, t, cache, eps=1e-4))
    got = linalg.maha_logits(x, t, cache, eps=1e-4, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_pca_matches_jax_up_to_sign():
    from summer_clip_tpu.methods import linalg as jl

    rng = np.random.RandomState(1)
    x = (rng.randn(30, 4) @ rng.randn(4, 12) + 0.01 * rng.randn(30, 12)).astype(np.float32)
    jp, pp = jl.PCA(3), linalg.PCA(3, device="cpu")
    want, got = np.asarray(jp.fit_transform(x)), pp.fit_transform(x).numpy()
    sign = np.sign((np.asarray(jp.components_) * pp.components_.numpy()).sum(1))
    np.testing.assert_allclose(pp.components_.numpy() * sign[:, None], np.asarray(jp.components_),
                               atol=1e-4)
    np.testing.assert_allclose(got * sign[None], want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pp.mean_.numpy(), np.asarray(jp.mean_), atol=1e-6)


@pytest.mark.parametrize("cov", ["diag", "full"])
def test_fixed_means_gmm_steps_match_jax(cov):
    from summer_clip_tpu.methods import em as jem

    x, means = _mixture()
    kw = dict(covariance_type=cov, max_iter=4, tol=1e-12)
    jg = jem.FixedMeansGMM(means_init=means, **kw).fit(x)
    pg = em.FixedMeansGMM(means_init=means, device="cpu", **kw).fit(x)
    np.testing.assert_array_equal(pg.means.numpy(), means)
    np.testing.assert_allclose(pg.weights_.numpy(), np.asarray(jg.weights_), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(pg.covariances_.numpy(), np.asarray(jg.covariances_),
                               rtol=1e-4, atol=1e-5)
    assert pg.lower_bound_ == pytest.approx(jg.lower_bound_, rel=1e-5)
    want = jg.predict_log_proba(x)
    np.testing.assert_allclose(pg.predict_log_proba(x), want, rtol=1e-3,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(pg.predict_proba(x).sum(1), 1.0, atol=1e-5)
    # converged runs stop early, as the JAX loop does
    short = em.FixedMeansGMM(means_init=means, covariance_type=cov, max_iter=100, tol=1e-1,
                             device="cpu").fit(x)
    assert short.lower_bound_ == pytest.approx(
        jem.FixedMeansGMM(means_init=means, covariance_type=cov, max_iter=100,
                          tol=1e-1).fit(x).lower_bound_, rel=1e-5)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    from summer_clip_torch.models.clip import build_clip, to_openai_state_dict
    from summer_clip_torch.store import FeatureStore

    tmp = tmp_path_factory.mktemp("analysis")
    model, _ = build_clip("test-vit", torch.Generator().manual_seed(5), device="cpu")
    ckpt = tmp / "test_vit.pt"
    torch.save(to_openai_state_dict(model), ckpt)
    width = int(model.text_projection.shape[1])
    # the synthetic dataset: 4 classes, 8 train and 4 test images a class, in class order
    rng = np.random.default_rng(0)
    features = FeatureStore(tmp / "features")
    for split, per_class in (("train", 8), ("test", 4)):
        labels = np.repeat(np.arange(4, dtype=np.int32), per_class)
        features.save(f"synthetic_{split}-test-vit", labels=labels,
                      features=rng.standard_normal((labels.shape[0], width)).astype(np.float32))
    return tmp / "features", ckpt


# |maha logits (port) - maha logits (JAX)| / max |logit|: see the module docstring
TOL_MAHA_LOGITS_REL = 1e-3


@pytest.mark.parametrize("app,kind,extra", [
    ("class_projector", None, ["pca.n_components=[2,4]"]),
    ("maha_distance", "maha_result", ["cache.features_key=synthetic_train-test-vit"]),
    ("train_em", "em_result", ["em_model.max_iter=5"]),
])
def test_analysis_app_matches_jax(store, tmp_path, monkeypatch, app, kind, extra):
    import importlib

    root, ckpt = store
    argv = ["dataset_name=synthetic", "dataset=synthetic_test", "dataset.load_images=false",
            "clip=test_vit", f"clip.checkpoint_path={ckpt}", f"store.root={root}",
            "data.features_key=synthetic_test-test-vit", *extra]
    runs, logits = {}, {}
    for pkg in ("summer_clip_tpu", "summer_clip_torch"):
        runs[pkg] = tmp_path / pkg
        runs[pkg].mkdir()
        monkeypatch.chdir(runs[pkg])
        port = ["meta.device=cpu"] if pkg == "summer_clip_torch" else []
        module = importlib.import_module(f"{pkg}.apps.{app}")
        if app == "maha_distance":   # keep the logits the app classifies by
            def kept(*a, _fn=module.maha_logits, _pkg=pkg, **k):
                out = _fn(*a, **k)
                logits[_pkg] = np.asarray(out)
                return out
            monkeypatch.setattr(module, "maha_logits", kept)
        module.run(argv=port + argv)
    if app == "maha_distance":
        want = logits["summer_clip_tpu"]
        assert logits["summer_clip_torch"].shape == want.shape == (16, 4)
        np.testing.assert_allclose(logits["summer_clip_torch"], want, rtol=0,
                                   atol=TOL_MAHA_LOGITS_REL * np.abs(want).max())
    pick = ((lambda r: "n_components" in r) if kind is None
            else (lambda r: r.get("type") == kind))
    got = [r for r in _records(runs["summer_clip_torch"]) if pick(r)]
    want = [r for r in _records(runs["summer_clip_tpu"]) if pick(r)]
    assert got and len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("n_components", "acc1", "acc5"):
            if k in w:
                assert g[k] == pytest.approx(w[k], abs=1e-6), (g, w)
    if app == "train_em":
        from summer_clip_torch.engine.checkpoint import load_pytree

        saved = load_pytree(next(runs["summer_clip_torch"].rglob("em_model.ckpt")))
        assert set(saved) == {"weights", "covariances", "means"}
        assert saved["covariances"].shape == saved["means"].shape   # diagonal: (K, D)
