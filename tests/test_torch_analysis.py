"""The analysis methods and apps of the port against the JAX package.

``methods.linalg`` (``maha_logits``, ``PCA``) and ``methods.em``
(``FixedMeansGMM``, full and diagonal covariances, a few EM steps) on the same
numpy inputs, f32 on both sides: the inverse of the scatter matrix and the
Cholesky factors are the two libraries' own, so results agree to a relative
1e-4 (1e-3 for the full-covariance log-densities, whose ~100 terms each carry
a triangular solve). A PCA component may come out negated: the test aligns
signs before comparing.

Then ``class_projector``, ``maha_distance`` and ``train_em`` of both packages
run once each over one feature store (the port's ``save_features`` on
``synthetic`` with a ``test-vit`` checkpoint both load) and their accuracy
records agree.
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
    got = linalg.maha_logits(x, t, cache, eps=1e-4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_pca_matches_jax_up_to_sign():
    from summer_clip_tpu.methods import linalg as jl

    rng = np.random.RandomState(1)
    x = (rng.randn(30, 4) @ rng.randn(4, 12) + 0.01 * rng.randn(30, 12)).astype(np.float32)
    jp, pp = jl.PCA(3), linalg.PCA(3)
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
    pg = em.FixedMeansGMM(means_init=means, **kw).fit(x)
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
    short = em.FixedMeansGMM(means_init=means, covariance_type=cov, max_iter=100, tol=1e-1).fit(x)
    assert short.lower_bound_ == pytest.approx(
        jem.FixedMeansGMM(means_init=means, covariance_type=cov, max_iter=100,
                          tol=1e-1).fit(x).lower_bound_, rel=1e-5)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    from summer_clip_torch.apps import save_features
    from summer_clip_torch.models.clip import build_clip, to_openai_state_dict

    tmp = tmp_path_factory.mktemp("analysis")
    model, _ = build_clip("test-vit", torch.Generator().manual_seed(5))
    ckpt = tmp / "test_vit.pt"
    torch.save(to_openai_state_dict(model), ckpt)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        save_features.run(argv=[
            "meta.device=cpu", "dataset_name=synthetic", "dataset@train_dataset=synthetic_train",
            "dataset@test_dataset=synthetic_test", "clip=test_vit", f"clip.checkpoint_path={ckpt}",
            "data.batch_size=8", f"store.root={tmp / 'features'}"])
    finally:
        os.chdir(cwd)
    return tmp / "features", ckpt


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
    runs = {}
    for pkg in ("summer_clip_tpu", "summer_clip_torch"):
        runs[pkg] = tmp_path / pkg
        runs[pkg].mkdir()
        monkeypatch.chdir(runs[pkg])
        port = ["meta.device=cpu"] if pkg == "summer_clip_torch" else []
        importlib.import_module(f"{pkg}.apps.{app}").run(argv=port + argv)
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
