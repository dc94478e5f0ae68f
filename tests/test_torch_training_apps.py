"""The port's training apps end to end on the CPU at test size, and the
adapter trainer against the JAX package's.

``train_coop`` (CoOp, and Gumbel v1a1 with the suffix fluency loss through a
``test-gpt`` ClipGPT), ``eval_prompt``, and ``train_adapter`` -> ``eval_adapter``
run through their entry points over features that the port's
``save_features`` stored, and write the records and files that the JAX
package's e2e tests assert (``tests/test_apps_e2e.py``). The adapter trainers
of both packages start from the same parameters (the JAX Dense kernels
(in, out) carried into ``nn.Linear`` (out, in)), the same CLIP weights and the
same classifier; after two epochs of AdamW their parameters agree to 1e-4 in
f32 (Adam's step normalisation carries f32 sums in another order into the
weights; measured against an f64 run) and to 1e-9 in f64.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def _records(run_root: Path, kind: str):
    recs = []
    for p in run_root.rglob("records.jsonl"):
        recs.extend(r for r in map(json.loads, p.read_text().splitlines()) if r.get("type") == kind)
    return recs


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    from summer_clip_torch.apps import save_features

    tmp = tmp_path_factory.mktemp("apps")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        save_features.run(argv=[
            "meta.device=cpu", "dataset_name=synthetic", "dataset@train_dataset=synthetic_train",
            "dataset@test_dataset=synthetic_test", "clip=test_vit", "data.batch_size=8",
            f"store.root={tmp / 'features'}"])
    finally:
        os.chdir(cwd)
    return tmp / "features"


@pytest.fixture()
def rundir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


COMMON = ["meta.device=cpu", "clip=test_vit", "dataset_name=synthetic"]


def test_train_coop_writes_prompts_and_checkpoints(store, rundir):
    from summer_clip_torch.apps import train_coop

    train_coop.run(argv=COMMON + [
        "dataset=synthetic_train", "dataset.load_images=false",
        "dataset@val_dataset=synthetic_test", "val_dataset.load_images=false",
        f"store.root={store}", "data.features_key=synthetic_train-test-vit",
        "data.val_features_key=synthetic_test-test-vit", "data.batch_size=8",
        "training.epochs_num=2", "prompt.length=4", "dataset_info.k_shots=-1", "clip_seq_len=16"])
    recs = _records(rundir, "prompt")
    assert [r["epoch"] for r in recs] == [1, 2] and len(recs[-1]["prompt_ids"]) == 4
    ckpt_dir, = rundir.rglob("checkpoints/epoch_2")
    assert {"model.ckpt", "meta.yaml", "prompt.yaml"} <= {p.name for p in ckpt_dir.iterdir()}
    epochs = [r for p in rundir.rglob("records.jsonl") for r in map(json.loads, p.read_text().splitlines())
              if "val/acc1" in r]
    assert len(epochs) == 2 and all(0 <= r["val/acc1"] <= 100 for r in epochs)


def test_train_coop_gumbel_with_fluency(store, rundir):
    from summer_clip_torch.apps import train_coop

    train_coop.run(argv=COMMON + [
        "dataset=synthetic_train", "dataset.load_images=false", "val_dataset=null",
        f"store.root={store}", "data.features_key=synthetic_train-test-vit", "data.batch_size=8",
        "training.epochs_num=1", "prompt.length=3", "prompt_model=gumbel_v1a1",
        "temp_scheduler=linear", "temp_scheduler.steps_num=4", "lm_loss=suffix",
        "loss.fluency=0.5", "loss.entropy=0.01", "+gpt.gpt_config=test-gpt",
        "+gpt.emb_hid_dim=16", "+gpt.head_hid_dim=16", "clip_seq_len=16"])
    assert _records(rundir, "prompt")
    epoch = next(r for p in rundir.rglob("records.jsonl")
                 for r in map(json.loads, p.read_text().splitlines()) if "loss/fluency" in r)
    assert np.isfinite(epoch["loss/fluency"]) and np.isfinite(epoch["loss/entropy"])


@pytest.mark.parametrize("head", [["prompt_model.head.hidden_dim=16"],
                                  ["prompt_model.head.kind=lora", "prompt_model.head.rank=4"]],
                         ids=["adapter", "lora"])
def test_train_coop_gumbel_v3a1_writes_prompts(store, rundir, head):
    """The JAX e2e test of the autoregressive proposer
    (``tests/test_apps_e2e.py::TestGumbelV3``) on the port, both heads: the
    prompt record and the proposer's checkpoint."""
    from summer_clip_torch.apps import train_coop

    train_coop.run(argv=COMMON + [
        "dataset=synthetic_train", "dataset.load_images=false", "val_dataset=null",
        f"store.root={store}", "data.features_key=synthetic_train-test-vit", "data.batch_size=8",
        "training.epochs_num=1", "prompt.length=2", "prompt_model=gumbel_v3a1", *head,
        "+gpt.gpt_config=test-gpt", "+gpt.emb_hid_dim=16", "+gpt.head_hid_dim=16",
        "clip_seq_len=16", "dataset_info.k_shots=-1"])
    recs = _records(rundir, "prompt")
    assert recs and len(recs[-1]["prompt_ids"]) == 2
    ckpt_dir, = rundir.rglob("checkpoints/epoch_1")
    assert (ckpt_dir / "model.ckpt").exists()


def test_eval_prompt_writes_an_accuracy_record(store, rundir):
    from summer_clip_torch.apps import eval_prompt

    eval_prompt.run(argv=COMMON + [
        "dataset=synthetic_test", "dataset.load_images=false", f"store.root={store}",
        "clip_data.features_key=synthetic_test-test-vit",
        'prompts_texts=["a photo of a", "an image of a"]'])
    recs = _records(rundir, "eval_prompt")
    assert recs and len(recs[-1]["prompts"]) == 2 and 0 <= recs[-1]["acc1"] <= 100


def test_train_adapter_then_eval_adapter(store, rundir):
    from summer_clip_torch.apps import eval_adapter, train_adapter

    train_adapter.run(argv=COMMON + [
        "dataset=synthetic_train", "dataset.load_images=false", f"store.root={store}",
        "data.features_key=synthetic_train-test-vit", "data.batch_size=8",
        "training.epochs_num=2", "training.adam_params.lr=0.01"])
    ckpt_dir, = rundir.rglob("checkpoints/epoch_2")
    assert (ckpt_dir / "model.ckpt").exists() and (ckpt_dir / "meta.yaml").exists()
    eval_adapter.run(argv=COMMON + [
        "dataset=synthetic_test", "dataset.load_images=false", f"store.root={store}",
        f"eval.checkpoint_dir={ckpt_dir}", "eval.features_key=synthetic_test-test-vit"])
    recs = _records(rundir, "eval_adapter")
    assert recs and 0.0 <= recs[-1]["acc1"] <= 100.0


def _adapter_state(jparams):
    """The JAX adapter's params -> the port's state dict: Dense kernels
    (in, out) become ``nn.Linear`` weights (out, in)."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            elif k == "kernel":
                out[prefix + "weight"] = torch.from_numpy(np.ascontiguousarray(np.asarray(v).T))
            else:
                out[prefix + k] = torch.from_numpy(np.array(v))

    walk(jparams, "")
    return out


@pytest.mark.parametrize("adapter", ["linear", "original_image"])
def test_adapter_weights_match_jax_after_two_epochs(store, rundir, adapter):
    import jax
    import jax.numpy as jnp

    from summer_clip_tpu.apps import train_adapter as jta
    from summer_clip_tpu.core import config as JC
    from summer_clip_tpu.core.log_utils import StreamingMeans as JMeans

    import summer_clip_torch.apps.train_adapter as pta
    from summer_clip_torch.core import config as PC
    from summer_clip_torch.core.log_utils import StreamingMeans
    from summer_clip_torch.models.clip import from_flax_variables

    overrides = ["dataset_name=synthetic", "dataset=synthetic_train", "dataset.load_images=false",
                 "clip=test_vit", f"store.root={store}", f"adapter={adapter}",
                 "data.features_key=synthetic_train-test-vit", "data.batch_size=8",
                 "training.adam_params.lr=0.01"]

    def compose(module, package, extra=()):
        cfg = module.compose(ROOT / package / "conf", "train_adapter", overrides + list(extra))
        cfg.pop("hydra")
        return cfg

    def two_epochs(f64: bool):
        """Both trainers from the JAX trainer's start, on its classifier, two
        epochs; the final parameters as state dicts."""
        jt = jta.ClipAdapterTrainer(compose(JC, "summer_clip_tpu"))
        jt.setup()
        variables = jax.tree_util.tree_map(np.asarray, jt_session_variables(jt))

        def session(*a, _create=pta.create_clip_session, **k):
            s = _create(*a, **k)
            s.model.load_state_dict(from_flax_variables(variables))
            return s

        real = pta.create_clip_session
        pta.create_clip_session = session
        try:
            pt = pta.ClipAdapterTrainer(compose(PC, "summer_clip_torch", ["meta.device=cpu"]))
            pt.setup()
        finally:
            pta.create_clip_session = real
        np.testing.assert_allclose(pt.text_features.numpy(), np.asarray(jt.text_features),
                                   rtol=1e-5, atol=1e-5)
        # the two towers' classifiers part by up to 1e-5, which Adam carries into
        # the weights: both trainers train on the JAX trainer's classifier
        pt.text_features = torch.from_numpy(np.array(jt.text_features, np.float32))
        pt.adapter.load_state_dict(_adapter_state(jax.tree_util.tree_map(np.asarray, jt.params)))
        if f64:
            jt.params = jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x), jnp.float64),
                                               jt.params)
            jt.opt_state = jt.tx.init(jt.params)
            jt.features = jt.features.astype(np.float64)
            jt.text_features = np.asarray(jt.text_features, np.float64)
            pt.adapter.double()
            pt.features, pt.text_features = pt.features.double(), pt.text_features.double()
            pt.setup_optimizer()
        for epoch in (1, 2):
            jt.train_epoch(epoch, JMeans())
            pt.train_epoch(epoch, StreamingMeans())
        want = _adapter_state(jax.tree_util.tree_map(np.asarray, jt.params))
        got = pt.adapter.state_dict()
        assert set(got) == set(want)
        return got, want

    # f32, the trainers as they run. Adam divides each step by its gradient's
    # size, so f32 sums in another order move a weight by more than their own
    # rounding: over 16 synthetic draws (the images follow the process's hash
    # seed) the two packages parted by up to 3.1e-5 in the linear head after
    # two epochs, the JAX trainer 2.2e-5 and the port's 9.2e-6 from the f64
    # trajectory on that draw.
    got, want = two_epochs(f64=False)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-4, err_msg=k)
    # f64: the same training function, step for step (4e-14 apart on those draws)
    jax.config.update("jax_enable_x64", True)
    try:
        got, want = two_epochs(f64=True)
    finally:
        jax.config.update("jax_enable_x64", False)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-9, atol=1e-10,
                                   err_msg=k)


def jt_session_variables(trainer):
    """The CLIP variables the JAX adapter trainer encoded its classifier with
    (its session is local to ``setup_model``: rebuilt from the same config)."""
    from summer_clip_tpu.apps.common import create_clip_session

    cfg = trainer.cfg.clip
    return create_clip_session(cfg.model_name, cfg.get("checkpoint_path"), cfg.get("dtype")).variables
