"""CLIP-search of the port against the JAX package, end to end on the CPU.

Both packages run in this one process (``SyntheticDataset.render`` seeds from
the salted ``hash(impath)``, so images agree only within a process): the same
``test-vit`` weights from one OpenAI-layout ``.pt``, save_features ->
save_image_outs -> image_attention over all 8 selection strategies, Hard and
Softmax values, two betas and two alphas. The records must be equal on every
key, accuracies to 1e-4 (f32 on both sides; sums in another order move a logit
by ~1e-6, which flips no rank on this grid). Follows
``tests/test_apps_e2e.py::TestImageAttention``.
"""

import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

TOPK_GROUPS = ("topk", "topk_prob", "topk_per_gold", "topk_prob_per_gold",
               "per_pred_class_random", "per_gold_class_random", "global_random")
# the port runs on the card unless told otherwise; the JAX package picks its backend
CPU = {"summer_clip_tpu": [], "summer_clip_torch": ["meta.device=cpu"]}
# two cache sizes per strategy: one below the split's 8 rows per class, one above
GRID = (["cache.alpha=[0.0,1.0]", "cache_weights_strategy.beta=[1.0,5.5]"]
        + [f"cache_strategies.{g}.topk=[2,16]" for g in TOPK_GROUPS])


def _records(run_root: Path, kind: str):
    recs = []
    for p in sorted(run_root.rglob("records.jsonl")):
        # a strategy's ``_target_`` names its package: the one difference allowed
        text = p.read_text().replace("summer_clip_tpu.", "summer_clip_torch.")
        recs.extend(json.loads(line) for line in text.splitlines())
    return [r for r in recs if r.get("type") == kind]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from summer_clip_torch.models.clip import build_clip, to_openai_state_dict

    model, _ = build_clip("test-vit", torch.Generator().manual_seed(5), device="cpu")
    path = tmp_path_factory.mktemp("ckpt") / "test_vit.pt"
    torch.save(to_openai_state_dict(model), path)
    return str(path)


def _run_search(pkg: str, root: Path, ckpt: str, monkeypatch, values: str, extra=()) -> Path:
    apps = {name: importlib.import_module(f"{pkg}.apps.{name}")
            for name in ("save_features", "save_image_outs", "image_attention")}
    store = root / "features"
    common = ["clip=test_vit", f"clip.checkpoint_path={ckpt}", "dataset_name=synthetic",
              f"store.root={store}", *CPU[pkg]]
    runs = [
        ("save_features", ["dataset@train_dataset=synthetic_train",
                           "dataset@test_dataset=synthetic_test", "data.batch_size=8",
                           "save_train_outs=false"]),
        ("save_image_outs", ["dataset=synthetic_train", "dataset.load_images=false",
                             "data.features_key=synthetic_train-test-vit",
                             "data.output_key=synthetic_train_outs-test-vit"]),
        ("image_attention", ["dataset=synthetic_test", "dataset@cache.dataset=synthetic_train",
                             "dataset.load_images=false", "cache.dataset.load_images=false",
                             "data.features_key=synthetic_test-test-vit",
                             "cache.features_key=synthetic_train-test-vit",
                             "cache.outs_key=synthetic_train_outs-test-vit",
                             f"cache_value_strategy={values}", *GRID, *extra,
                             *(["cache_value_strategy.scale=[0.1,1.0]"]
                               if values == "softmax_cache" else [])]),
    ]
    for name, argv in runs:
        sub = root / name
        sub.mkdir(parents=True)
        monkeypatch.chdir(sub)
        apps[name].run(argv=common + argv)
    return root


def _by_combo(recs):
    def key(r):
        return json.dumps({k: r[k] for k in ("cache_strategy", "cache_weights_strategy",
                                             "cache_value_strategy", "alpha")}, sort_keys=True)
    out = {key(r): r for r in recs}
    assert len(out) == len(recs)
    return out


@pytest.mark.parametrize("values", ["hard_cache", "softmax_cache"])
def test_image_attention_matches_jax(tmp_path, monkeypatch, ckpt, values):
    from summer_clip_tpu.store import FeatureStore

    jroot = _run_search("summer_clip_tpu", tmp_path / "jax", ckpt, monkeypatch, values)
    troot = _run_search("summer_clip_torch", tmp_path / "torch", ckpt, monkeypatch, values)

    js, ts = FeatureStore(jroot / "features"), FeatureStore(troot / "features")
    np.testing.assert_allclose(ts.load("synthetic_train_outs-test-vit", "outs"),
                               js.load("synthetic_train_outs-test-vit", "outs"),
                               rtol=1e-4, atol=1e-4)
    for kind in ("zero_shot", "cache_info"):
        got, want = _records(troot, kind), _records(jroot, kind)
        assert got and len(got) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k, v in w.items():
                if isinstance(v, float):
                    assert g[k] == pytest.approx(v, abs=1e-4), (kind, k)
                else:
                    assert g[k] == v, (kind, k)
    got = _by_combo(_records(troot, "searcher_result"))
    want = _by_combo(_records(jroot, "searcher_result"))
    n_values = 1 if values == "hard_cache" else 2
    # 7 strategies x 2 topk + all_logits, x values x 2 betas x 2 alphas
    assert len(want) == (7 * 2 + 1) * n_values * 2 * 2
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].keys() == w.keys()
        assert got[k]["acc1"] == pytest.approx(w["acc1"], abs=1e-4), k
        assert got[k]["acc5"] == pytest.approx(w["acc5"], abs=1e-4), k
    strategies = {json.dumps(r["cache_strategy"], sort_keys=True) for r in want.values()}
    assert len({json.loads(s)["_target_"].rsplit(".", 1)[1] for s in strategies}) == 8


def test_bf16_residence_and_saved_artifacts(tmp_path, monkeypatch, ckpt):
    """cache.resident_dtype=bf16 with every run_saves switch on: the grid runs,
    alpha = 0 equals zero-shot, and labels, selections and predictions land
    on disk."""
    root = _run_search("summer_clip_torch", tmp_path, ckpt, monkeypatch, "hard_cache",
                       extra=["cache.resident_dtype=bf16", "run_saves.save_labels=true",
                              "run_saves.save_cache_inds=true", "run_saves.save_preds=true",
                              "cache_strategy@cache_strategies.threshold=threshold",
                              "cache_strategies.threshold.threshold=[0.1]"])
    zero = _records(root, "zero_shot")[-1]
    recs = _records(root, "searcher_result")
    assert recs and all(r["acc1"] == pytest.approx(zero["acc1"], abs=1e-6)
                        for r in recs if r["alpha"] == 0.0)
    targets = {r["cache_strategy"]["_target_"].rsplit(".", 1)[1] for r in recs}
    assert "ThresholdStrategy" in targets and len(targets) == 9
    run_dir = next((root / "image_attention").rglob("records.jsonl")).parent
    assert (run_dir / "gold_labels" / "test_labels.npy").exists()
    assert (run_dir / "gold_labels" / "cache_labels.npy").exists()
    assert list((run_dir / "cache_ids").glob("tensor_*.npy"))
    preds = np.load(recs[0]["preds_path"]) if Path(recs[0]["preds_path"]).is_absolute() \
        else np.load(run_dir / recs[0]["preds_path"])
    assert preds.shape == (len(np.load(run_dir / "gold_labels" / "test_labels.npy")),)


def test_replaced_outs_take_host_values(tmp_path, monkeypatch, ckpt):
    """cache.replace_outs_with_golds=true: values are built on the host from
    the gold one-hots (the device path steps aside) and still follow the
    gather's row order: alpha = 0 equals zero-shot and the records are sane."""
    root = _run_search("summer_clip_torch", tmp_path, ckpt, monkeypatch, "hard_cache",
                       extra=["cache.replace_outs_with_golds=true"])
    infos = _records(root, "cache_info")
    assert infos and all(i["acc1_replace"] == 100.0 for i in infos)
    recs = _records(root, "searcher_result")
    assert recs and all(0.0 <= r["acc1"] <= 100.0 for r in recs)


def test_class_distribution_and_labels_apps(tmp_path, monkeypatch, ckpt):
    from summer_clip_torch.apps import class_distribution, save_image_labels

    root = _run_search("summer_clip_torch", tmp_path, ckpt, monkeypatch, "hard_cache")
    store = root / "features"
    sub = root / "class_distribution"
    sub.mkdir()
    monkeypatch.chdir(sub)
    class_distribution.run(argv=[
        "meta.device=cpu", "clip=test_vit", f"clip.checkpoint_path={ckpt}",
        "dataset_name=synthetic", f"store.root={store}", "dataset=synthetic_test",
        "dataset@cache.dataset=synthetic_train",
        "dataset.load_images=false", "cache.dataset.load_images=false",
        "data.features_key=synthetic_test-test-vit",
        "cache.features_key=synthetic_train-test-vit",
        "cache.outs_key=synthetic_train_outs-test-vit"])
    run_dir = next(sub.rglob("records.jsonl")).parent
    assert len(list((run_dir / "selected_cache").glob("*.npy"))) == 7 * 6 + 1   # default topk lists
    assert (run_dir / "cache_labels.npy").exists()

    sub = root / "labels"
    sub.mkdir()
    monkeypatch.chdir(sub)
    out = sub / "labels.npy"
    save_image_labels.run(argv=["meta.device=cpu", "dataset_name=synthetic",
                                "dataset=synthetic_train", "dataset.load_images=false",
                                f"data.output_labels={out}"])
    onehot = np.load(out)
    assert onehot.ndim == 2 and (onehot.sum(1) == 1).all()


def test_other_weights_strategy_takes_the_dense_route():
    """The cache kernels compute Tip-Adapter weights and nothing else: another
    weights strategy gets the JAX app's dense fallback, its own ``transform``
    times the values in the selection's own row order, one (1, Nt, C) block a
    strategy, as the JAX app computes it."""
    from summer_clip_tpu.methods.cache import HardCacheStrategy as JHard

    from summer_clip_torch.apps.image_attention import ImageAttention
    from summer_clip_torch.methods.cache import CacheWeightsStrategy, HardCacheStrategy

    class FlatWeights(CacheWeightsStrategy):
        def __init__(self, scale):
            self.scale = scale

        def transform(self, test_image_features, cache_image_features):
            return self.scale * np.add.outer(np.arange(len(test_image_features)),
                                             np.arange(len(cache_image_features))).astype(np.float32)

    rng = np.random.default_rng(0)
    app = object.__new__(ImageAttention)
    app.device = torch.device("cpu")
    app.test_image_features = rng.standard_normal((5, 8)).astype(np.float32)
    cache_features = rng.standard_normal((7, 8)).astype(np.float32)
    cache_outs = rng.standard_normal((7, 3)).astype(np.float32)
    logged = []
    app._log_results = lambda sp, wp, vp, alphas, accs, logits: logged.append((wp, accs, logits))
    app._sweep_weights_values(cache_features, cache_outs, {},
                              {"_target_": FlatWeights, "scale": [1.0, 2.0]},
                              {"_target_": HardCacheStrategy}, [0.0],
                              lambda c: np.zeros((len(c), 1, 2)))
    assert [wp["scale"] for wp, _, _ in logged] == [1.0, 2.0]
    values = JHard().transform(cache_outs)
    for wp, accs, logits in logged:
        weights = FlatWeights(wp["scale"]).transform(app.test_image_features, cache_features)
        np.testing.assert_allclose(logits.numpy(), weights @ values, rtol=1e-6)
        assert accs.shape == (1, 2)
