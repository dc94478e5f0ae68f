"""Tip-Adapter-F and the ImageNet entry point of the port against the JAX package.

- ``engine.optim.cosine_decay_schedule`` against optax's, step for step.
- ``methods.tip.finetune_cache_keys`` against the JAX function on the same
  numpy inputs (NK = 64, D = 32, C = 8, three epochs): the same shuffle
  (``np.random.RandomState``), the same AdamW over the same schedule, f32 on
  both sides; the keys agree to 1e-5.
- ``apps.tip_adapter`` with ``finetune.enabled=true`` of both packages on
  ``synthetic`` with the same ``test-vit`` weights, in one process (the
  synthetic images seed from the salted ``hash(impath)``): the ``tip_*`` and
  ``tipf_*`` records agree.
- ``apps.tip_adapter.run_imagenet`` composes ``tip_adapter_imagenet`` and runs.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from summer_clip_torch.engine import optim
from summer_clip_torch.methods import tip


def _records(run_root: Path, kind: str):
    recs = []
    for p in run_root.rglob("records.jsonl"):
        recs.extend(r for r in map(json.loads, p.read_text().splitlines()) if r.get("type") == kind)
    return recs


@pytest.mark.parametrize("lr,steps,alpha", [(1e-3, 37, 0.0), (0.01, 20, 0.25)])
def test_cosine_decay_schedule_matches_optax(lr, steps, alpha):
    import jax.numpy as jnp
    import optax

    want = np.asarray(optax.cosine_decay_schedule(lr, steps, alpha)(jnp.arange(50)))
    sched = optim.cosine_decay_schedule(lr, steps, alpha)
    got = np.asarray([sched(i) for i in range(50)], np.float32)
    assert got[0] == np.float32(lr)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        optim.cosine_decay_schedule(lr, 0)


def test_finetune_cache_keys_matches_jax():
    from summer_clip_tpu.methods import tip as jtip

    rng = np.random.default_rng(0)
    nk, d, c, n = 64, 32, 8, 48

    def unit(k):
        a = rng.standard_normal((k, d)).astype(np.float32)
        return a / np.linalg.norm(a, axis=1, keepdims=True)

    keys, feats = unit(nk), unit(n)
    key_labels = np.repeat(np.arange(c), nk // c)
    values = np.eye(c, dtype=np.float32)[key_labels]
    labels = rng.integers(0, c, n)
    clip_logits = (10.0 * rng.standard_normal((n, c))).astype(np.float32)
    kw = dict(epochs=3, lr=0.01, batch_size=16, weight_decay=0.01, seed=3)
    jrecs, precs = [], []
    want = jtip.finetune_cache_keys(feats, labels, clip_logits, keys, values, 3.0, 1.5,
                                    log_fn=jrecs.append, **kw)
    got = tip.finetune_cache_keys(feats, labels, clip_logits, keys, values, 3.0, 1.5,
                                  log_fn=precs.append, device="cpu", **kw)
    assert got.shape == (nk, d) and np.abs(got - keys).max() > 1e-3   # the keys moved
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert [r["epoch"] for r in precs] == [0, 1, 2]
    for p, j in zip(precs, jrecs):
        assert p["type"] == j["type"] == "tipf_epoch"
        assert p["loss"] == pytest.approx(j["loss"], rel=1e-5)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from summer_clip_torch.models.clip import build_clip, to_openai_state_dict

    model, _ = build_clip("test-vit", torch.Generator().manual_seed(3), device="cpu")
    path = tmp_path_factory.mktemp("ckpt") / "test_vit.pt"
    torch.save(to_openai_state_dict(model), path)
    return str(path)


FINETUNE = ["dataset=synthetic", "root_path=''", "shots=4", "augment_epoch=1",
            "data.batch_size=8", "search_step=[4,3]", "search_scale=[7,3]",
            "finetune.enabled=true", "finetune.epochs=8", "finetune.lr=0.01"]


def test_finetune_app_matches_jax(tmp_path, monkeypatch, ckpt):
    import importlib

    from summer_clip_torch.store import FeatureStore

    roots = {}
    for pkg in ("summer_clip_tpu", "summer_clip_torch"):
        app = importlib.import_module(f"{pkg}.apps.tip_adapter")
        roots[pkg] = tmp_path / pkg
        roots[pkg].mkdir()
        monkeypatch.chdir(roots[pkg])
        cpu = ["meta.device=cpu"] if pkg == "summer_clip_torch" else []
        app.run(argv=[*cpu, "clip=test_vit", f"clip.checkpoint_path={ckpt}", *FINETUNE])
    jax_root, port_root = roots["summer_clip_tpu"], roots["summer_clip_torch"]

    epochs = _records(port_root, "tipf_epoch")
    assert len(epochs) == 8 and epochs[-1]["loss"] < epochs[0]["loss"]
    for g, w in zip(epochs, _records(jax_root, "tipf_epoch")):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-4, abs=1e-5)
    for kind in ("zero_shot", "tip_result", "tip_searched", "tipf_result", "tipf_searched"):
        got, want = _records(port_root, kind), _records(jax_root, kind)
        assert got and len(got) == len(want), kind
        for g, w in zip(got, want):
            for k in ("acc1", "beta", "alpha"):
                if k in w:
                    assert g[k] == pytest.approx(w[k], abs=1e-6), (kind, k, g, w)
    fs, js = (FeatureStore(next(root.rglob("caches/synthetic"))) for root in (port_root, jax_root))
    for key in ("cache_4shots_finetuned", "train_eval_features"):
        assert key in fs
        np.testing.assert_allclose(fs.load(key, "features"), js.load(key, "features"),
                                   atol=1e-4)


def test_run_imagenet_composes_and_runs(tmp_path, monkeypatch, ckpt):
    from summer_clip_torch.apps import tip_adapter

    monkeypatch.chdir(tmp_path)
    tip_adapter.run_imagenet(argv=[
        "meta.device=cpu", "clip=test_vit", f"clip.checkpoint_path={ckpt}", *FINETUNE,
        "finetune.epochs=2"])
    assert len(_records(tmp_path, "tipf_epoch")) == 2
    for kind in ("zero_shot", "tip_result", "tip_searched", "tipf_result", "tipf_searched"):
        recs = _records(tmp_path, kind)
        assert recs and all(0.0 <= r["acc1"] <= 100.0 for r in recs), kind
    # the ImageNet config: 7 prompt templates and its own initial (beta, alpha)
    tip_result, = _records(tmp_path, "tip_result")
    assert (tip_result["beta"], tip_result["alpha"]) == (5.5, 1.0)
