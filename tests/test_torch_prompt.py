"""Prompt learning of the port against the JAX package: the collator's tables,
``find_nearest``, every ported prompt model's ``apply``, and one ``train_coop``
step (loss, prompt gradient, parameters after three steps) at ``test_vit``.

Both packages build their ``CoOpTrainer`` from their own ``train_coop.yaml``
with the same overrides on the CPU in f32; the JAX trainer's CLIP variables,
ClipGPT variables and prompt parameters are carried into the port's through
the converters, and both read the same stored features. Tolerances: tables and
ids exact; prompt-model outputs 1e-6; the loss and prompt gradient 1e-4
relative (the text tower's sums in another order); parameters after three
AdamW steps 1e-5.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from summer_clip_torch.methods import prompt_learner as PL
from summer_clip_torch.methods import prompt_models as PM
from summer_clip_torch.models.tokenizer import get_tokenizer

ROOT = Path(__file__).resolve().parent.parent


def test_collator_tables_equal_the_jax_packages():
    from summer_clip_tpu.methods import prompt_learner as JPL

    tok = get_tokenizer()
    classes = ["golden_retriever", "a very long class name " * 6, "cat"]
    mine, theirs = PL.LeftPromptCollator(tok, 4, 16), JPL.LeftPromptCollator(tok, 4, 16)
    toks = mine.tokenize_classes(classes)
    assert toks == theirs.tokenize_classes(classes)
    table, jtable = mine.build_class_table(toks + [[]]), theirs.build_class_table(toks + [[]])
    for a, b in zip(table, jtable):
        np.testing.assert_array_equal(a, b)
    idx = np.array([2, 0, 3, 2])
    prompt = np.array([7, 8, 9, 10])
    got = mine.get_gpt_input(table, idx, prompt_ids=torch.from_numpy(prompt))
    want = theirs.get_gpt_input(jtable, idx, prompt_ids=prompt)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ids, lens = mine.get_clip_input(table, idx)
    jids, jlens = theirs.get_clip_input(jtable, idx)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))


def test_splice_and_lm_losses_match_the_jax_package():
    import jax.numpy as jnp

    from summer_clip_tpu.methods import prompt_learner as JPL

    rng = np.random.default_rng(0)
    emb = rng.standard_normal((3, 10, 6)).astype(np.float32)
    prompt = rng.standard_normal((4, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        PL.splice_prompt_embeds(torch.from_numpy(emb), torch.from_numpy(prompt)).numpy(),
        np.asarray(JPL.splice_prompt_embeds(jnp.asarray(emb), jnp.asarray(prompt))))
    ids = rng.integers(0, 20, (3, 10))
    mask = (np.arange(10)[None] < np.array([[10], [7], [5]])).astype(np.float32)
    logits = rng.standard_normal((3, 10, 20)).astype(np.float32)
    for mine, theirs in ((PL.FullLMLoss(), JPL.FullLMLoss()),
                         (PL.SuffixLMLoss(4), JPL.SuffixLMLoss(4)),
                         (PL.NoLMLoss(), JPL.NoLMLoss())):
        got = mine.transform(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(logits))
        want = theirs.transform(jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(logits))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("p", [2.0, 1.0])
def test_find_nearest_ids_equal_the_jax_packages(p):
    import jax.numpy as jnp

    from summer_clip_tpu.methods import prompt_models as JPM

    rng = np.random.default_rng(1)
    table = rng.standard_normal((300, 16)).astype(np.float32)
    prompt = table[[5, 17, 250]] + 0.1 * rng.standard_normal((3, 16)).astype(np.float32)
    got = PM.find_nearest(torch.from_numpy(prompt), torch.from_numpy(table), p).numpy()
    np.testing.assert_array_equal(got, np.asarray(JPM.find_nearest(jnp.asarray(prompt),
                                                                   jnp.asarray(table), p)))
    assert list(got) == [5, 17, 250]


@pytest.mark.parametrize("name", ["CoOp", "VQVAE1", "VQVAE2", "Gumbelv0a1", "Gumbelv1a1"])
@pytest.mark.parametrize("allowed", [None, "subset"])
def test_prompt_model_outputs_equal_the_jax_packages(name, allowed):
    import jax
    import jax.numpy as jnp

    from summer_clip_tpu.methods import prompt_models as JPM

    rng = np.random.default_rng(2)
    table = rng.standard_normal((200, 8)).astype(np.float32)
    allowed_tokens = None if allowed is None else sorted(rng.choice(200, 50, replace=False))
    kw = dict(clip_embs=table, prompt_len=3, allowed_tokens=allowed_tokens)
    jm, pm = getattr(JPM, name)(**kw), getattr(PM, name)(device="cpu", **kw)
    jparams = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jparams = {k: v + 0.3 * rng.standard_normal(v.shape).astype(np.float32)
               for k, v in jparams.items()}
    params = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in jparams.items()}
    for training in (True, False):
        want = jm.apply({k: jnp.asarray(v) for k, v in jparams.items()}, 0.5, training)
        got = pm.apply(params, 0.5, training)
        assert set(got) == set(want)
        for key, value in want.items():
            g = got[key]
            g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
            np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(value, np.float64),
                                       rtol=1e-6, atol=1e-6, err_msg=key)
    np.testing.assert_array_equal(pm.decode_ids(params), jm.decode_ids(
        {k: jnp.asarray(v) for k, v in jparams.items()}))


@pytest.mark.parametrize("kind", ["adapter", "lora"])
def test_gumbel_v3a1_parameters_are_the_jax_trees(kind):
    """Gumbelv3a1's parameters are its proposer's, named by their paths in the
    JAX package's tree under ``proposer`` (what the converters carry across),
    with the JAX shapes; the rollout's ids are prompt_len vocabulary ids."""
    import jax
    import jax.numpy as jnp

    from summer_clip_tpu.methods import gpt_heads as JGH
    from summer_clip_tpu.methods import prompt_models as JPM
    from summer_clip_tpu.models import gpt2 as JG

    from summer_clip_torch.methods import gpt_heads as GH
    from summer_clip_torch.models import gpt2 as TG

    kw = dict(clip_vocab_size=50, clip_emb_dim=8, emb_hid_dim=8, head_hid_dim=8)
    jgpt = JG.ClipGPT(JG.GPT2_CONFIGS["test-gpt"], **kw)
    jvars = jgpt.init(jax.random.PRNGKey(0), jnp.zeros((1, 2), jnp.int32))
    gpt = TG.ClipGPT(TG.GPT2_CONFIGS["test-gpt"], **kw).load_tree(TG.from_flax_variables(
        jax.tree_util.tree_map(np.asarray, jvars)))
    heads = {"adapter": (JGH.AdapterGPT(jgpt, jvars, 4), GH.AdapterGPT(gpt, 4)),
             "lora": (JGH.LoRAGPT(jgpt, jvars, rank=2), GH.LoRAGPT(gpt, rank=2))}[kind]
    table = np.random.default_rng(3).standard_normal((50, 8)).astype(np.float32)
    mk = dict(bos_token_id=1, clip_embs=table, prompt_len=3)
    jparams = JPM.Gumbelv3a1(proposer=heads[0], **mk).init(jax.random.PRNGKey(1))
    model = PM.Gumbelv3a1(proposer=heads[1], device="cpu", **mk)
    params = model.init(torch.Generator().manual_seed(1))
    want = {k: np.shape(v) for k, v in GH.flatten(jparams).items()}
    assert {k: tuple(v.shape) for k, v in params.items()} == want
    assert all(v.requires_grad for v in params.values())
    ids = model.decode_ids(params)
    assert ids.shape == (3,) and ((0 <= ids) & (ids < 50)).all()


# --------------------------------------------------------------------------- #
# one train_coop step, both packages
# --------------------------------------------------------------------------- #
OVERRIDES = {
    "coop": [],
    "gumbel": ["prompt_model=gumbel_v1a1", "lm_loss=suffix", "loss.fluency=0.5",
               "loss.entropy=0.01", "+gpt.gpt_config=test-gpt", "+gpt.emb_hid_dim=16",
               "+gpt.head_hid_dim=16"],
}


def _overrides(features, extra):
    return ["dataset_name=synthetic", "dataset=synthetic_train", "dataset.load_images=false",
            "val_dataset=null", "clip=test_vit", "clip_seq_len=16", "prompt.length=4",
            "dataset_info.k_shots=-1", "training.warmup_steps=2", "training.clip_grad_norm=1.0",
            f"data.image_features_path={features}", *extra]


def _compose(config_module, package, overrides):
    cfg = config_module.compose(ROOT / package / "conf", "train_coop", overrides)
    cfg.pop("hydra")
    return cfg


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """Both packages' trainers per variant, the port's carrying the JAX
    trainer's CLIP, ClipGPT and prompt parameters."""
    import jax

    from summer_clip_tpu.apps import train_coop as jtc
    from summer_clip_tpu.core import config as JC

    import summer_clip_torch.apps.train_coop as ptc
    from summer_clip_torch.core import config as PC
    from summer_clip_torch.models import gpt2 as tg
    from summer_clip_torch.models.clip import from_flax_variables

    tmp = tmp_path_factory.mktemp("coop")
    features = tmp / "features.npy"
    np.save(features, np.random.default_rng(3).standard_normal((32, 32)).astype(np.float32))
    cwd = os.getcwd()
    os.chdir(tmp)
    out = {}
    try:
        for variant, extra in OVERRIDES.items():
            jcfg = _compose(JC, "summer_clip_tpu", _overrides(features, extra))
            jt = jtc.CoOpTrainer(jcfg)
            jt.setup()
            variables = jax.tree_util.tree_map(np.asarray, jt.session.variables)

            def session(*a, _create=ptc.create_clip_session, _v=variables, **k):
                s = _create(*a, **k)
                s.model.load_state_dict(from_flax_variables(_v))
                return s

            def gpt(*a, _build=ptc.build_clip_gpt, _jt=jt, **k):
                m = _build(*a, **k)
                return m.load_tree(tg.from_flax_variables(
                    jax.tree_util.tree_map(np.asarray, _jt.gpt_variables)))

            real = ptc.create_clip_session, ptc.build_clip_gpt
            ptc.create_clip_session, ptc.build_clip_gpt = session, gpt
            try:
                pt = ptc.CoOpTrainer(_compose(PC, "summer_clip_torch",
                                              _overrides(features, extra) + ["meta.device=cpu"]))
                pt.setup()
            finally:
                ptc.create_clip_session, ptc.build_clip_gpt = real
            with torch.no_grad():
                for k, v in jt.prompt_params.items():
                    pt.prompt_params[k].copy_(torch.from_numpy(np.asarray(v)))
            out[variant] = (jt, pt)
    finally:
        os.chdir(cwd)
    return out


def _batch(jt, pt):
    import jax.numpy as jnp

    idx = np.arange(8, 16)
    labels = jt.labels[idx]
    jax_args = (jnp.asarray(jt.image_features[idx]), jnp.asarray(labels), jnp.asarray(labels),
                jnp.asarray(1.0, jnp.float32))
    port_args = (pt.image_features[torch.from_numpy(idx)], torch.from_numpy(labels), labels, 1.0)
    return jax_args, port_args


@pytest.mark.parametrize("variant", list(OVERRIDES))
def test_train_coop_step_matches_jax(trainers, variant):
    """Loss, every metric and the prompt gradient of one step, then the prompt
    parameters after three steps of AdamW with clipping on the warmup cosine."""
    jt, pt = trainers[variant]
    jax_args, port_args = _batch(jt, pt)
    jparams, jstate = jt.prompt_params, jt.opt_state
    for step in range(3):
        jparams, jstate, jmetrics, jgrads = jt._train_step(jparams, jstate, *jax_args)
        metrics, grads = pt.train_step(*port_args)
        if step == 0:
            assert set(metrics) == set(jmetrics)
            for k in metrics:
                np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-4,
                                           atol=1e-6, err_msg=k)
            assert set(grads) == set(jgrads)
            for k, g in grads.items():
                want = np.asarray(jgrads[k])
                assert np.linalg.norm(want) > 0
                np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                           atol=1e-4 * np.abs(want).max(), err_msg=k)
    for k, v in pt.prompt_params.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(jparams[k]), atol=1e-5, err_msg=k)


def test_remat_gives_the_same_gradient(trainers):
    """``clip.remat``: every block under ``torch.utils.checkpoint`` (the
    JAX package's ``nn.remat``) gives the same loss and prompt gradient."""
    _, pt = trainers["coop"]
    _, port_args = _batch(*trainers["coop"])
    model = pt.session.model

    def loss_and_grad():
        params = {k: v.detach().clone().requires_grad_() for k, v in pt.prompt_params.items()}
        loss, _ = pt.loss_fn(params, *port_args)
        loss.backward()
        return float(loss), params["prompt_embs"].grad

    want = loss_and_grad()
    model.set_remat(True)
    try:
        got = loss_and_grad()
    finally:
        model.set_remat(False)
    assert got[0] == want[0]
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
