"""Prompt search and the autoregressive proposer of the port against the JAX
package: ``methods/gpt_heads`` (AdapterGPT, LoRAGPT, ``apply_lora``),
``Gumbelv3a1`` and one ``train_coop`` step with it (both heads),
``methods/autoprompt`` (``hotflip_attack``, ``TopPrompter``, ``hotflip_step``),
``methods/fluentprompt`` (the projection, one Langevin step) and a whole
``train_autoprompt`` run, at the JAX e2e tests' sizes (``test_vit``,
``test-gpt``, ``clip_seq_len=16``).

Parameters cross from the JAX package into the port through the converters
(``models.clip.from_flax_variables``, ``models.gpt2.from_flax_variables``,
``methods.gpt_heads.from_flax_params``); random draws cannot cross, so the
Langevin noise is carried across as an input. Tolerances: head logits and
merged trees 1e-5; the trainer's metrics and gradients 1e-4 relative (the
text tower's sums in another order); prompt ids exact and heap losses 1e-4
relative.

The ``cuda`` tests run the phases (g), (h) and (i) of ``chip_smoke.py`` at
test size on the card; they skip without one.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from summer_clip_torch.methods import autoprompt as AP
from summer_clip_torch.methods import fluentprompt as FP
from summer_clip_torch.methods import gpt_heads as GH
from summer_clip_torch.methods import prompt_models as PM

ROOT = Path(__file__).resolve().parent.parent


# --------------------------------------------------------------------------- #
# gpt_heads
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def tiny_clip_gpt():
    """A JAX ClipGPT (test-gpt over a 300-token CLIP table) and the port's
    copy of it on the CPU."""
    import jax
    import jax.numpy as jnp

    from summer_clip_tpu.models import gpt2 as JG

    from summer_clip_torch.models import gpt2 as TG

    kw = dict(clip_vocab_size=300, clip_emb_dim=16, emb_hid_dim=16, head_hid_dim=16)
    jmodel = JG.ClipGPT(JG.GPT2_CONFIGS["test-gpt"], **kw)
    jvars = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    jvars = jax.tree_util.tree_map(np.asarray, jvars)
    port = TG.ClipGPT(TG.GPT2_CONFIGS["test-gpt"], **kw)
    port.load_tree(TG.from_flax_variables(jvars))
    return jmodel, jvars, port.eval()


def _perturbed(tree, seed, scale):
    import jax

    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(np.shape(a)).astype(np.float32), tree)


def _rollout_logits(head, params, embeds, cache):
    out = []
    for i in range(embeds.shape[1]):
        logits, cache = head(params, embeds[:, i:i + 1], cache)
        out.append(np.asarray(logits.detach() if isinstance(logits, torch.Tensor) else logits))
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("kind", ["adapter", "lora"])
def test_head_logits_equal_the_jax_packages(tiny_clip_gpt, kind):
    """Three cached steps of AdapterGPT / LoRAGPT, the JAX head's parameters
    (perturbed, so LoRA's B is not zero) carried across: logits to 1e-5."""
    import jax
    import jax.numpy as jnp

    from summer_clip_tpu.methods import gpt_heads as JGH

    jmodel, jvars, port = tiny_clip_gpt
    if kind == "adapter":
        jhead, head = JGH.AdapterGPT(jmodel, jvars, 8), GH.AdapterGPT(port, 8)
    else:
        jhead, head = JGH.LoRAGPT(jmodel, jvars, rank=4, scale=0.5), GH.LoRAGPT(port, 4, 0.5)
    jparams = _perturbed(jhead.init(jax.random.PRNGKey(1)), 2, 0.05)
    params = GH.from_flax_params(jparams, "cpu")
    assert set(params) == set(head.init(torch.Generator().manual_seed(0)))
    embeds = np.random.default_rng(3).standard_normal((2, 3, 16)).astype(np.float32)
    want = _rollout_logits(jhead, jax.tree_util.tree_map(jnp.asarray, jparams),
                           jnp.asarray(embeds), jhead.init_cache(2, 4))
    got = _rollout_logits(head, params, torch.from_numpy(embeds), head.init_cache(2, 4))
    assert got.shape == want.shape == (2, 3, 300)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_apply_lora_merges_the_tree_as_the_jax_package(tiny_clip_gpt):
    """The merged tree equals JAX's leaf for leaf (the JAX factors carried
    across by the converter); only the attention's ``c_attn`` / ``c_proj``
    kernels carry factors (not ``mlp_c_proj``)."""
    import jax

    from summer_clip_tpu.methods import gpt_heads as JGH

    from summer_clip_torch.models import gpt2 as TG

    _, jvars, port = tiny_clip_gpt
    jlora = _perturbed(JGH.init_lora_params(jvars["params"], jax.random.PRNGKey(4), rank=4), 5, 0.1)
    want = GH.flatten(jax.tree_util.tree_map(np.asarray,
                                             JGH.apply_lora(jvars["params"], jlora, 0.5)))
    tree = TG.from_flax_variables(jvars)
    lora = {k: v.detach() for k, v in GH.from_flax_params(jlora, "cpu").items()}
    got = GH.flatten(GH.apply_lora(tree, lora, 0.5))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    targets = {k[:-2] for k in GH.init_lora_params(tree, torch.Generator(), 4, device="cpu")
               if k.endswith(".a")}
    assert targets == {f"core.h_{i}.attn.{m}.kernel" for i in range(2) for m in ("c_attn", "c_proj")}


def test_rollout_backpropagates_and_the_decode_cache_stays_in_place(tiny_clip_gpt):
    """Gumbelv3a1's rollout differentiates through every cached step (the
    buffers rebuilt out of place), while a decode step without grad still
    writes the buffers it was given (gen_gpt's and the serving engine's
    cache)."""
    _, _, port = tiny_clip_gpt
    table = np.random.default_rng(6).standard_normal((300, 16)).astype(np.float32)
    for head in (GH.AdapterGPT(port, 8), GH.LoRAGPT(port, 4)):
        model = PM.Gumbelv3a1(proposer=head, bos_token_id=5, clip_embs=table, prompt_len=4,
                              device="cpu")
        params = model.init(torch.Generator().manual_seed(7))
        if isinstance(head, GH.LoRAGPT):   # B starts at zero: give A a gradient
            with torch.no_grad():
                for k, v in params.items():
                    v.add_(0.05 * torch.randn(v.shape, generator=torch.Generator().manual_seed(8)))
        out = model.apply(params)
        out["clip_embs"].square().sum().backward()
        grads = [p.grad for p in params.values()]
        assert all(g is not None and torch.isfinite(g).all() for g in grads)
        assert sum(float(g.abs().sum()) for g in grads) > 0
    cache = port.init_cache(1, 4)
    k0 = cache[0]["k"]
    with torch.no_grad():
        new = port(inputs_embeds=torch.ones(1, 1, 16), cache=cache)["cache"]
    assert new[0]["k"] is k0 and new[0]["index"] == 1 and float(k0[:, 0].abs().sum()) > 0


def test_gumbel_v3a1_outputs_equal_the_jax_packages(tiny_clip_gpt):
    """``apply`` of Gumbelv3a1 over a restricted vocabulary (the BOS from the
    global table, the feedback from the restricted one), the adapter head's
    parameters carried across: probabilities, embeddings and ids."""
    import jax
    import jax.numpy as jnp

    from summer_clip_tpu.methods import gpt_heads as JGH
    from summer_clip_tpu.methods import prompt_models as JPM

    jmodel, jvars, port = tiny_clip_gpt
    rng = np.random.default_rng(9)
    table = rng.standard_normal((300, 16)).astype(np.float32)
    allowed = sorted(rng.choice(300, 120, replace=False).tolist())
    kw = dict(bos_token_id=3, clip_embs=table, prompt_len=3, allowed_tokens=allowed)
    jm = JPM.Gumbelv3a1(proposer=JGH.AdapterGPT(jmodel, jvars, 8), **kw)
    pm = PM.Gumbelv3a1(proposer=GH.AdapterGPT(port, 8), device="cpu", **kw)
    jparams = {"proposer": _perturbed(jm.init(jax.random.PRNGKey(2))["proposer"], 10, 0.3)}
    params = GH.from_flax_params(jparams, "cpu")
    want = jm.apply(jax.tree_util.tree_map(jnp.asarray, jparams), 0.5)
    got = pm.apply(params, 0.5)
    assert set(got) == set(want)
    for key in ("clip_embs", "gpt_embs"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    np.testing.assert_array_equal(got["ids"].numpy(), np.asarray(want["ids"]))
    np.testing.assert_array_equal(pm.decode_ids(params),
                                  jm.decode_ids(jax.tree_util.tree_map(jnp.asarray, jparams)))


# --------------------------------------------------------------------------- #
# one train_coop step with Gumbelv3a1, both packages
# --------------------------------------------------------------------------- #
HEADS = {"adapter": ["prompt_model.head.hidden_dim=16"],
         "lora": ["prompt_model.head.kind=lora", "prompt_model.head.rank=4"]}


def _coop_overrides(features, extra):
    return ["dataset_name=synthetic", "dataset=synthetic_train", "dataset.load_images=false",
            "val_dataset=null", "clip=test_vit", "clip_seq_len=16", "prompt.length=3",
            "dataset_info.k_shots=-1", "training.warmup_steps=2", "training.clip_grad_norm=1.0",
            "prompt_model=gumbel_v3a1", "lm_loss=suffix", "loss.fluency=0.5",
            "+gpt.gpt_config=test-gpt", "+gpt.emb_hid_dim=16", "+gpt.head_hid_dim=16",
            f"data.image_features_path={features}", *extra]


def _compose(config_module, package, app, overrides):
    cfg = config_module.compose(ROOT / package / "conf", app, overrides)
    cfg.pop("hydra")
    return cfg


def _with_jax_weights(module, variables, gpt_variables):
    """Patch ``module``'s session and ClipGPT builders so the port's trainer
    gets the JAX trainer's CLIP and ClipGPT weights; returns the undo."""
    import jax

    from summer_clip_torch.models import gpt2 as tg
    from summer_clip_torch.models.clip import from_flax_variables

    real = module.create_clip_session, module.build_clip_gpt

    def session(*a, **k):
        s = real[0](*a, **k)
        s.model.load_state_dict(from_flax_variables(variables))
        return s

    def gpt(*a, **k):
        return real[1](*a, **k).load_tree(tg.from_flax_variables(
            jax.tree_util.tree_map(np.asarray, gpt_variables)))

    module.create_clip_session, module.build_clip_gpt = session, gpt

    def undo():
        module.create_clip_session, module.build_clip_gpt = real
    return undo


@pytest.fixture(scope="module")
def v3_trainers(tmp_path_factory):
    """Both packages' CoOp trainers with Gumbelv3a1 per head, the port's
    carrying the JAX trainer's weights and (perturbed) proposer parameters."""
    import jax
    import jax.numpy as jnp

    from summer_clip_tpu.apps import train_coop as jtc
    from summer_clip_tpu.core import config as JC

    import summer_clip_torch.apps.train_coop as ptc
    from summer_clip_torch.core import config as PC

    tmp = tmp_path_factory.mktemp("v3")
    features = tmp / "features.npy"
    np.save(features, np.random.default_rng(3).standard_normal((32, 32)).astype(np.float32))
    cwd = os.getcwd()
    os.chdir(tmp)
    out = {}
    try:
        for head, extra in HEADS.items():
            jt = jtc.CoOpTrainer(_compose(JC, "summer_clip_tpu", "train_coop",
                                          _coop_overrides(features, extra)))
            jt.setup()
            jt.prompt_params = jax.tree_util.tree_map(
                jnp.asarray, {"proposer": _perturbed(jt.prompt_params["proposer"], 11, 0.05)})
            jt.opt_state = jt.tx.init(jt.prompt_params)
            undo = _with_jax_weights(ptc, jax.tree_util.tree_map(np.asarray, jt.session.variables),
                                     jt.gpt_variables)
            try:
                pt = ptc.CoOpTrainer(_compose(PC, "summer_clip_torch", "train_coop",
                                              _coop_overrides(features, extra)
                                              + ["meta.device=cpu"]))
                pt.setup()
            finally:
                undo()
            want = GH.from_flax_params(jax.tree_util.tree_map(np.asarray, jt.prompt_params), "cpu")
            assert set(want) == set(pt.prompt_params)
            with torch.no_grad():
                for k, v in want.items():
                    pt.prompt_params[k].copy_(v)
            out[head] = (jt, pt)
    finally:
        os.chdir(cwd)
    return out


@pytest.mark.parametrize("head", list(HEADS))
def test_train_coop_gumbel_v3a1_step_matches_jax(v3_trainers, head):
    """Loss, every metric and the proposer's gradient of one step (clip CE,
    the suffix fluency loss, the gradient through every rollout step), then
    the parameters after two AdamW steps: metrics and gradients to 1e-4."""
    jt, pt = v3_trainers[head]
    import jax.numpy as jnp

    idx = np.arange(8, 16)
    labels = jt.labels[idx]
    jax_args = (jnp.asarray(jt.image_features[idx]), jnp.asarray(labels), jnp.asarray(labels),
                jnp.asarray(1.0, jnp.float32))
    port_args = (pt.image_features[torch.from_numpy(idx)], torch.from_numpy(labels), labels, 1.0)
    jparams, jstate = jt.prompt_params, jt.opt_state
    for step in range(2):
        jparams, jstate, jmetrics, jgrads = jt._train_step(jparams, jstate, *jax_args)
        metrics, grads = pt.train_step(*port_args)
        if step == 0:
            assert set(metrics) == set(jmetrics) >= {"loss/clip", "loss/fluency"}
            for k in metrics:
                np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-4,
                                           atol=1e-6, err_msg=k)
            want = GH.flatten({"proposer": jgrads["proposer"]})
            assert set(grads) == set(want)
            for k, g in grads.items():
                w = np.asarray(want[k])
                assert np.linalg.norm(w) > 0, k
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                           err_msg=k)
    final = GH.flatten({"proposer": jparams["proposer"]})
    for k, v in pt.prompt_params.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(final[k]), atol=1e-5, err_msg=k)


# --------------------------------------------------------------------------- #
# AutoPrompt and FluentPrompt
# --------------------------------------------------------------------------- #
def test_hotflip_attack_and_top_prompter_equal_the_jax_packages():
    import jax.numpy as jnp

    from summer_clip_tpu.methods import autoprompt as JAP

    rng = np.random.default_rng(12)
    table = rng.standard_normal((500, 16)).astype(np.float32)
    grad = rng.standard_normal(16).astype(np.float32)
    want = JAP.hotflip_attack(jnp.asarray(grad), jnp.asarray(table), 7)
    np.testing.assert_array_equal(
        AP.hotflip_attack(torch.from_numpy(grad), torch.from_numpy(table), 7), want)
    # equal scores (a zero gradient): the lower index first, as jax.lax.top_k
    zero = np.zeros(16, np.float32)
    np.testing.assert_array_equal(
        AP.hotflip_attack(torch.from_numpy(zero), torch.from_numpy(table[:6]), 4),
        JAP.hotflip_attack(jnp.asarray(zero), jnp.asarray(table[:6]), 4))
    mine, theirs = AP.TopPrompter(3), JAP.TopPrompter(3)
    for i, loss in enumerate([2.0, 1.0, 3.0, 0.5, 1.5, 0.7]):
        mine.push([i, i + 1], loss)
        theirs.push([i, i + 1], loss)
    assert mine.items() == theirs.items()


def test_hotflip_step_matches_the_jax_package():
    """One move over the same closures (a quadratic loss): the same position
    from the same numpy seed, the same candidates, losses and acceptance."""
    import jax.numpy as jnp

    from summer_clip_tpu.methods import autoprompt as JAP

    rng = np.random.default_rng(13)
    table = rng.standard_normal((200, 8)).astype(np.float32)
    target = rng.standard_normal((4, 8)).astype(np.float32)

    def loss(embs, ids, batch):
        return float(((np.asarray(embs) - target * batch) ** 2).sum())

    def grad(embs, batch):
        return loss(embs, None, batch), 2.0 * (np.asarray(embs) - target * batch)

    infos = []
    for state, step, wrap in ((JAP.AutoPromptState(table, [1, 2, 3, 4]), JAP.hotflip_step,
                               jnp.asarray),
                              (AP.AutoPromptState(table, [1, 2, 3, 4]), AP.hotflip_step,
                               torch.from_numpy)):
        info = step(state, lambda e, b: (grad(e, b)[0], wrap(grad(e, b)[1].astype(np.float32))),
                    loss, [1.0, 0.5], num_cands=5, rng=np.random.default_rng(14))
        infos.append((info, list(state.prompt_ids)))
    (want, want_ids), (got, got_ids) = infos
    assert got_ids == want_ids
    for k in ("position", "accepted", "best_cand"):
        assert got[k] == want[k], k
    for k in ("curr_loss", "best_cand_loss"):
        assert got[k] == pytest.approx(want[k], rel=1e-6), k


def test_fluent_projection_and_a_langevin_step_equal_the_jax_packages():
    """The geometric beta schedule; one SGLD step on the same gradient with
    the JAX noise carried into the port; then the projection onto the nearest
    vocabulary rows (ids and embeddings)."""
    import jax.numpy as jnp

    from summer_clip_tpu.methods import fluentprompt as JFP

    js, ps = JFP.geometric_beta_schedule(1.0, 1e-4, 10), FP.geometric_beta_schedule(1.0, 1e-4, 10)
    for step in (0, 1, 5, 10):
        assert ps(step) == pytest.approx(float(js(jnp.asarray(step))), rel=1e-6)

    rng = np.random.default_rng(15)
    table = rng.standard_normal((100, 8)).astype(np.float32)
    jstate = JFP.FluentPromptState(table, [4, 9, 30])
    state = FP.FluentPromptState(table, [4, 9, 30], device="cpu")
    np.testing.assert_array_equal(state.params["prompt_embs"].detach().numpy(),
                                  np.asarray(jstate.params["prompt_embs"]))
    g = rng.standard_normal((3, 8)).astype(np.float32)
    lr = 0.05
    jtx = JFP.make_langevin_optimizer(lr, 1.0, 1e-4, 10, seed=0)
    updates, _ = jtx.update({"prompt_embs": jnp.asarray(g)}, jtx.init(jstate.params),
                            jstate.params)
    noise = (np.asarray(updates["prompt_embs"]) + lr * g) / np.sqrt(2.0 * lr * js(jnp.asarray(0)))
    tx = FP.make_langevin_optimizer(state.params, lr, 1.0, 1e-4, 10, seed=0)
    tx.optimizer.noise = lambda p: torch.from_numpy(noise.astype(np.float32))
    embs = state.params["prompt_embs"]
    embs.grad = torch.from_numpy(g)
    tx.step()
    want = np.asarray(jstate.params["prompt_embs"]) + np.asarray(updates["prompt_embs"])
    np.testing.assert_allclose(embs.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    jstate.params = {"prompt_embs": jnp.asarray(want + 0.4 * rng.standard_normal(want.shape))}
    with torch.no_grad():
        embs.copy_(torch.from_numpy(np.asarray(jstate.params["prompt_embs"])))
    assert state.project() == jstate.project()
    assert state.params["prompt_embs"] is embs       # the optimizer's leaf stays
    np.testing.assert_array_equal(embs.detach().numpy(), np.asarray(jstate.params["prompt_embs"]))


def _autoprompt_argv(features, ckpt):
    return ["dataset_name=synthetic", "dataset=synthetic_train", "dataset.load_images=false",
            "val_dataset=null", "clip=test_vit", f"clip.checkpoint_path={ckpt}",
            f"data.image_features_path={features}", "data.batch_size=8",
            "training.epochs_num=1", "dataset_info.k_shots=-1", "clip_seq_len=16",
            "prompt.init_prompter.length=3", "search.num_cands=4", "search.search_steps=1",
            "search.save_every=2"]


def test_train_autoprompt_run_matches_jax(tmp_path, monkeypatch):
    """A whole AutoPrompt run (4 HotFlip steps) of each package over the same
    CLIP weights and features: the same prompt ids after every step (the
    positions from the same numpy seeds) and the heap dumps' losses to 1e-4."""
    from summer_clip_tpu.apps import train_autoprompt as japp

    from summer_clip_torch.apps import train_autoprompt as papp
    from summer_clip_torch.models.clip import build_clip, to_openai_state_dict

    model, _ = build_clip("test-vit", torch.Generator().manual_seed(16), device="cpu")
    ckpt = tmp_path / "test_vit.pt"
    torch.save(to_openai_state_dict(model), ckpt)
    features = tmp_path / "features.npy"
    np.save(features, np.random.default_rng(17).standard_normal((32, 32)).astype(np.float32))
    heaps = {}
    for name, app, extra in (("jax", japp, []), ("port", papp, ["meta.device=cpu"])):
        run_dir = tmp_path / name
        run_dir.mkdir()
        monkeypatch.chdir(run_dir)
        app.run(argv=_autoprompt_argv(features, ckpt) + extra)
        heaps[name] = {p.parent.name: yaml.safe_load(p.read_text())
                       for p in run_dir.rglob("checkpoints/epoch_1/step_*/prompts.yaml")}
    assert set(heaps["port"]) == set(heaps["jax"]) == {"step_2", "step_4", "step_final"}
    for step, want in heaps["jax"].items():
        got = heaps["port"][step]
        assert [r["prompt_ids"] for r in got] == [r["prompt_ids"] for r in want], step
        assert [r["prompt_tokens"] for r in got] == [r["prompt_tokens"] for r in want]
        np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in want],
                                   rtol=1e-4, err_msg=step)


def test_train_autoprompt_fluentprompt_mode_keeps_vocabulary_rows(tmp_path, monkeypatch):
    """FluentPrompt end to end on the port: after the run the prompt is
    vocabulary rows exactly and the records are written."""
    from summer_clip_torch.apps import train_autoprompt as papp

    features = tmp_path / "features.npy"
    np.save(features, np.random.default_rng(18).standard_normal((32, 32)).astype(np.float32))
    captured = {}
    real = papp.run_trainer
    monkeypatch.setattr(papp, "run_trainer",
                        lambda cls, cfg: captured.setdefault("t", real(cls, cfg)))
    monkeypatch.chdir(tmp_path)
    argv = [a for a in _autoprompt_argv(features, "none") if "checkpoint_path" not in a]
    papp.run(argv=argv + ["meta.device=cpu", "search.mode=fluentprompt",
                          "training.learning_rate=0.01"])
    t = captured["t"]
    embs = t.state.params["prompt_embs"].detach()
    np.testing.assert_array_equal(embs.numpy(), t.clip_embs_table[t.state.prompt_ids])
    heap = yaml.safe_load(next(tmp_path.rglob("step_final/prompts.yaml")).read_text())
    assert heap and all(np.isfinite(r["loss"]) for r in heap)


# --------------------------------------------------------------------------- #
# on the card: chip_smoke's (g), (h), (i) at test size
# --------------------------------------------------------------------------- #
@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_prompt_search_gates_at_test_size(cuda, tmp_path):
    """(g) AutoPrompt and (h) FluentPrompt over a 2-block ViT-B/16-width text
    tower, (i) Gumbelv3a1 through a 256-wide ClipGPT with fluency: every gate
    and exact launch count of ``chip_smoke.check_prompt_search``."""
    import chip_smoke

    chip_smoke.run_small_prompt_search(tmp_path, "ghi")
