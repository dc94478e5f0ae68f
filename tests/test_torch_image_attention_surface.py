"""CLIP-search's remaining surface and the library's default device.

- ``img_attn_dataset@dataset_cfg=<dataset>`` composes the port's
  ``image_attention`` config to the JAX package's, for each of the 11 files;
- a weights strategy other than Tip-Adapter's takes the dense route
  (``weights @ values`` from its own ``transform``) in both packages: on one
  small store the records agree, accuracies to 1e-4 (f32 on both sides);
- every public function and class of the port that takes a ``device`` runs
  on the card when given none, and without a card raises and names
  ``device="cpu"``.

The ``cuda`` tests run phase (k) of ``chip_smoke.py`` at test size and the
default device on the card; they skip without one.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
DATASETS = sorted(p.stem for p in (REPO / "summer_clip_tpu" / "conf" / "img_attn_dataset").glob(
    "*.yaml"))


def _l2n(x):
    x = np.asarray(x, np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def port_tip_formula(beta: float):
    """Tip-Adapter's weights from a strategy the kernels do not know (the
    port's): ``exp(-beta (1 - f c^T))`` by its own ``transform``."""
    from summer_clip_torch.methods.cache import CacheWeightsStrategy

    class TipFormula(CacheWeightsStrategy):
        def transform(self, test_image_features, cache_image_features):
            return np.exp(-beta * (1.0 - _l2n(test_image_features) @ _l2n(cache_image_features).T))
    return TipFormula()


def jax_tip_formula(beta: float):
    """The same strategy on the JAX package's base class."""
    from summer_clip_tpu.methods.cache import CacheWeightsStrategy

    class TipFormula(CacheWeightsStrategy):
        def transform(self, test_image_features, cache_image_features):
            return np.exp(-beta * (1.0 - _l2n(test_image_features) @ _l2n(cache_image_features).T))
    return TipFormula()


@pytest.mark.parametrize("dataset", DATASETS)
def test_img_attn_dataset_override_composes_as_the_jax_package(dataset):
    from summer_clip_torch.core import config as TC
    from summer_clip_tpu.core import config as JC

    assert len(DATASETS) == 11
    over = [f"img_attn_dataset@dataset_cfg={dataset}"]
    got = TC.to_container(TC.compose(REPO / "summer_clip_torch" / "conf", "image_attention",
                                     over), resolve=False)
    want = JC.to_container(JC.compose(REPO / "summer_clip_tpu" / "conf", "image_attention",
                                      over), resolve=False)
    got.pop("hydra"), want.pop("hydra")
    text = json.dumps(want).replace("summer_clip_tpu", "summer_clip_torch")
    assert got == json.loads(text)
    assert got["dataset_cfg"]["cache"]["features_key"].startswith(dataset)


# --------------------------------------------------------------------------- #
# the dense route of another weights strategy, both packages
# --------------------------------------------------------------------------- #
GRID = (["cache.alpha=[0.0,1.0]", "cache_weights_strategy.beta=[1.0,5.5]"]
        + [f"cache_strategies.{g}.topk=[2,16]" for g in
           ("topk", "topk_prob", "topk_per_gold", "topk_prob_per_gold",
            "per_pred_class_random", "per_gold_class_random", "global_random")])


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """The port's save_features -> save_image_outs on ``synthetic`` at
    ``test_vit`` from one OpenAI-layout checkpoint (both packages read it)."""
    import os

    from summer_clip_torch.apps import save_features, save_image_outs
    from summer_clip_torch.models.clip import build_clip, to_openai_state_dict

    tmp = tmp_path_factory.mktemp("surface")
    model, _ = build_clip("test-vit", torch.Generator().manual_seed(21), device="cpu")
    ckpt = tmp / "test_vit.pt"
    torch.save(to_openai_state_dict(model), ckpt)
    common = ["meta.device=cpu", "clip=test_vit", f"clip.checkpoint_path={ckpt}",
              "dataset_name=synthetic", f"store.root={tmp / 'features'}"]
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        save_features.run(argv=common + ["dataset@train_dataset=synthetic_train",
                                         "dataset@test_dataset=synthetic_test",
                                         "data.batch_size=8", "save_train_outs=false"])
        save_image_outs.run(argv=common + ["dataset=synthetic_train", "dataset.load_images=false",
                                           "data.features_key=synthetic_train-test-vit",
                                           "data.output_key=synthetic_train_outs-test-vit"])
    finally:
        os.chdir(cwd)
    return tmp, ckpt


def _search_argv(tmp, ckpt, target):
    return ["clip=test_vit", f"clip.checkpoint_path={ckpt}", "dataset_name=synthetic",
            f"store.root={tmp / 'features'}", "dataset=synthetic_test",
            "dataset@cache.dataset=synthetic_train", "dataset.load_images=false",
            "cache.dataset.load_images=false", "data.features_key=synthetic_test-test-vit",
            "cache.features_key=synthetic_train-test-vit",
            "cache.outs_key=synthetic_train_outs-test-vit",
            f"cache_weights_strategy._target_={target}", *GRID]


def _searcher_records(run_root: Path):
    recs = []
    for p in sorted(run_root.rglob("records.jsonl")):
        text = (p.read_text().replace("summer_clip_tpu.", "summer_clip_torch.")
                .replace("jax_tip_formula", "port_tip_formula"))
        recs.extend(json.loads(line) for line in text.splitlines())
    out = {}
    for r in recs:
        if r.get("type") == "searcher_result":
            key = json.dumps({k: r[k] for k in ("cache_strategy", "cache_weights_strategy",
                                                "cache_value_strategy", "alpha")}, sort_keys=True)
            out[key] = r
    return out


@pytest.mark.parametrize("values", ["hard_cache", "softmax_cache"])
def test_other_weights_strategy_records_match_jax(store, tmp_path, monkeypatch, values):
    """A custom ``CacheWeightsStrategy`` computing Tip-Adapter's formula, Hard
    and Softmax values: both packages take their dense routes (the JAX app's
    ``transform`` then ``weights @ values``); every record agrees, and the
    records equal the port's kernel route on Tip-Adapter's own strategy."""
    from summer_clip_torch.apps import image_attention as papp
    from summer_clip_tpu.apps import image_attention as japp

    tmp, ckpt = store
    mod = __name__
    runs = {}
    for name, app, argv in (
            ("jax", japp, _search_argv(tmp, ckpt, f"{mod}.jax_tip_formula")),
            ("port", papp, _search_argv(tmp, ckpt, f"{mod}.port_tip_formula")
             + ["meta.device=cpu"]),
            ("kernels", papp, [a for a in _search_argv(tmp, ckpt, "x") if "._target_=" not in a]
             + ["meta.device=cpu"])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        app.run(argv=argv + [f"cache_value_strategy={values}"])
        runs[name] = _searcher_records(tmp_path / name)
    want, got = runs["jax"], runs["port"]
    assert len(want) == (7 * 2 + 1) * 2 * 2 * (1 if values == "hard_cache" else 3)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k]["acc1"] == pytest.approx(w["acc1"], abs=1e-4), k
        assert got[k]["acc5"] == pytest.approx(w["acc5"], abs=1e-4), k
    kernels = {k.replace("summer_clip_torch.methods.cache.TipAdapterWeightsStrategy",
                         f"{mod}.port_tip_formula"): r for k, r in runs["kernels"].items()}
    assert kernels.keys() == got.keys()
    for k, r in kernels.items():
        assert got[k]["acc1"] == pytest.approx(r["acc1"], abs=1e-4), k


# --------------------------------------------------------------------------- #
# the default device
# --------------------------------------------------------------------------- #
def _calls():
    """The public functions and classes that take a ``device``, each called
    without one on small inputs: the eleven that once defaulted to the CPU,
    then those of the prompt-search and ProLIP modules."""
    from summer_clip_torch.methods import (cache, em, gpt_heads, linalg, prolip, prompt_models,
                                           tip, zeroshot)
    from summer_clip_torch.models.clip import build_clip, load_clip

    rng = np.random.default_rng(22)
    f = _l2n(rng.standard_normal((6, 8)))
    keys = _l2n(rng.standard_normal((4, 8)))
    values = np.eye(2, dtype=np.float32)[[0, 1, 0, 1]]
    cl = rng.standard_normal((6, 2)).astype(np.float32)
    labels = np.array([0, 1, 0, 1, 0, 1])
    table = rng.standard_normal((10, 8)).astype(np.float32)

    def encode(tok):
        return torch.ones(tok.shape[0], 8, device=tok.device)

    return {
        "tip_logits": lambda: tip.tip_logits(cl, f, keys, values, 1.0, 1.0),
        "search_hp": lambda: tip.search_hp(f, labels, cl, keys, values, search_step=(2, 2)),
        "finetune_cache_keys": lambda: tip.finetune_cache_keys(f, labels, cl, keys, values,
                                                               1.0, 1.0, epochs=1),
        "cache_logits_for_betas": lambda: cache.cache_logits_for_betas(f, keys, values, [1.0]),
        "zeroshot_classifier": lambda: zeroshot.zeroshot_classifier(encode, ["cat"], ["a {}."]),
        "maha_logits": lambda: linalg.maha_logits(f, keys[:2], keys),
        "PCA": lambda: linalg.PCA(2).fit(f),
        "FixedMeansGMM": lambda: em.FixedMeansGMM(keys[:2], max_iter=1).fit(f),
        "build_clip": lambda: build_clip("test-vit"),
        "load_clip": lambda: load_clip(REPO / "no_such_checkpoint.pt"),
        "BasePromptModel": lambda: prompt_models.CoOp(clip_embs=table, prompt_len=2),
        "prolip_logits": lambda: prolip.prolip_logits(f, keys.T, keys[:2, :4], 10.0),
        "train_projection": lambda: prolip.train_projection(f, labels, keys[:2, :4], keys.T,
                                                            epochs=1),
        "from_flax_params": lambda: gpt_heads.from_flax_params({"fc1": {"bias": keys[0]}}),
        "EmbsAdapter.init": lambda: gpt_heads.EmbsAdapter(3).init(8, torch.Generator()),
        "init_lora_params": lambda: gpt_heads.init_lora_params(
            {"attn": {"c_attn": {"kernel": keys.T}}}, torch.Generator(), 2),
    }


NAMES = ["tip_logits", "search_hp", "finetune_cache_keys", "cache_logits_for_betas",
         "zeroshot_classifier", "maha_logits", "PCA", "FixedMeansGMM", "build_clip",
         "load_clip", "BasePromptModel", "prolip_logits", "train_projection",
         "from_flax_params", "EmbsAdapter.init", "init_lora_params"]


@pytest.mark.parametrize("name", NAMES)
def test_no_device_means_the_card_and_raises_without_one(monkeypatch, name):
    assert sorted(_calls()) == sorted(NAMES)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _calls()[name]()


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [n for n in NAMES if n != "load_clip"])
def test_cuda_no_device_runs_on_the_card(cuda, name):
    """Each runs when given no device, and what it returns lies on the card
    (a tensor, a dict of parameters, a module's parameters, or an object's
    ``device``; the host results of ``search_hp``, ``finetune_cache_keys`` and
    ``train_projection`` only run)."""
    out = _calls()[name]()
    if isinstance(out, tuple):
        out = out[0]
    if isinstance(out, np.ndarray):      # trained keys or W, returned to the host
        return
    if isinstance(out, dict):
        out = next(iter(out.values()))
    if isinstance(out, torch.nn.Module):
        out = next(out.parameters())
    device = out.device if isinstance(out, torch.Tensor) else getattr(out, "device", None)
    assert device is None or torch.device(device).type == "cuda", (name, device)


@pytest.mark.cuda
def test_cuda_dense_route_gate_at_test_size(cuda, tmp_path):
    """(k) at test size: a custom weights strategy's records against the
    kernel route's at the same betas, record by record."""
    import chip_smoke

    chip_smoke.run_small_prompt_search(tmp_path, "k")
