"""ClipGPT training in the port against the JAX package: ``apps/tokenize_dataset``,
``apps/train_gpt`` (the ClipGPT trainer), the GPT-2 stack's ``remat``, the f32
heads and the optimizer's saved state.

The JAX ``ClipGPTTrainer`` runs once (module fixture) at ``test-gpt`` in f32
with ``remat: true``, ``grad_accum_steps: 2`` and ``clip_grad_norm: 0.5``,
which binds: the first update's mean gradient over every leaf has a global
norm of 1.107 (``test_first_norm_is_over_every_leaf``), over the adapters
alone 0.076, so a norm over the trainable leaves only would not clip. Its initial tree crosses to the port through
``models.gpt2.from_flax_variables`` and the port's own resume route
(``pretrained.model``). Tolerances: per-step losses 2e-6 relative, the
adapters after the epoch 2e-5 absolute (f32 sums in another order, carried
through Adam).
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
CLIP_NORM = 0.5
COMMON = ["clip_gpt.gpt_config=test-gpt", "clip_gpt.clip_emb_dim=16",
          "clip_gpt.adapters.emb_hid_dim=16", "clip_gpt.adapters.head_hid_dim=16",
          "data_loader.train.batch_size=4", "data_loader.val.batch_size=4",
          "training.epochs_num=1", "training.grad_accum_steps=2",
          f"training.clip_grad_norm={CLIP_NORM}", "training.evals_per_epoch=1",
          "training.info_steps=1000", "training.bf16=false", "training.remat=true",
          "optim.adamw_kwargs.lr=0.01", "scheduler.warmup_part=0.2"]


class _Chdir:
    def __init__(self, path):
        self.path, self.old = path, None

    def __enter__(self):
        self.old = os.getcwd()
        os.chdir(self.path)

    def __exit__(self, *exc):
        os.chdir(self.old)


def _compose(package: str, overrides):
    if package == "summer_clip_tpu":
        from summer_clip_tpu.core import config as cfg_mod
    else:
        from summer_clip_torch.core import config as cfg_mod
    cfg = cfg_mod.compose(ROOT / package / "conf", "train_gpt", list(overrides))
    cfg.pop("hydra")
    return cfg


def _port_trainer(overrides, setup: bool = True):
    from summer_clip_torch.apps.train_gpt import ClipGPTTrainer

    trainer = ClipGPTTrainer(_compose("summer_clip_torch", COMMON + ["meta.device=cpu"]
                                      + list(overrides)))
    if setup:
        trainer.setup()
    return trainer


def _recording(trainer):
    """Wrap the port trainer's micro-step: its losses and each update's norm."""
    losses, norms = [], []
    step = trainer.train_step

    def wrapped(ids):
        count = trainer.tx.count
        loss = step(ids)
        losses.append(loss)
        if trainer.tx.count != count:
            norms.append(trainer.tx.inner.last_grad_norm)
        return loss

    trainer.train_step = wrapped
    return losses, norms


def _leaves(trainer):
    return {n: p.detach().clone() for n, p in trainer.model.named_parameters()}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from summer_clip_tpu.apps import tokenize_dataset as jtd

    root = tmp_path_factory.mktemp("train_gpt")
    with _Chdir(root):
        jtd.run(argv=["max_length=16", "source.n_docs=3", f"output_path={root}/c.npy",
                      "hydra.job.chdir=false"])
    tokens = np.load(root / "c.npy")
    # a subpart of 29 chunks: 7 micro-steps of 4, so 3 updates and a rest
    assert int(0.28 * len(tokens)) // 4 == 7, tokens.shape
    return root, [f"dataset.train.tokens_path={root}/c.npy", "dataset.train.subpart=0.28",
                  f"dataset.val.tokens_path={root}/c.npy"]


@pytest.fixture(scope="module")
def jax_run(corpus):
    """The JAX trainer's epoch: its initial tree, per-step losses and final params."""
    import jax

    from summer_clip_tpu.apps.train_gpt import ClipGPTTrainer as JT

    root, data = corpus
    run_dir = root / "jax"
    run_dir.mkdir()
    with _Chdir(run_dir):
        jt = JT(_compose("summer_clip_tpu", COMMON + data))
        jt.setup()
        init = jax.tree_util.tree_map(np.asarray, jt.params)
        losses = []
        step = jt._train_step

        def wrapped(params, opt_state, ids):
            out = step(params, opt_state, ids)
            losses.append(float(out[2]))
            return out

        jt._train_step = wrapped
        jt.train_loop()
    return {"init": init, "losses": losses, "trainer": jt,
            "final": jax.tree_util.tree_map(np.asarray, jt.params)}


@pytest.fixture(scope="module")
def init_ckpt(corpus, jax_run):
    """The JAX trainer's initial tree as a full port checkpoint."""
    from summer_clip_torch.engine import checkpoint as ckpt
    from summer_clip_torch.models.gpt2 import from_flax_variables

    root, _ = corpus
    return ckpt.save_checkpoint(root / "jax_init", params=from_flax_variables(jax_run["init"]))


@pytest.fixture(scope="module")
def port_run(corpus, init_ckpt):
    root, data = corpus
    run_dir = root / "port"
    run_dir.mkdir()
    with _Chdir(run_dir):
        pt = _port_trainer(data + [f"pretrained.model={init_ckpt}"])
        losses, norms = _recording(pt)
        pt.train_loop()
    return {"trainer": pt, "losses": losses, "norms": norms, "dir": run_dir}


def _flat_jax(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_jax(v, prefix + (str(k),))
        else:
            yield ".".join(prefix + (str(k),)), np.asarray(v)


def test_losses_match_the_jax_trainer(jax_run, port_run):
    want, got = jax_run["losses"], port_run["losses"]
    assert len(got) == len(want) == 7
    np.testing.assert_allclose(got, want, rtol=2e-6)


def test_adapters_match_the_jax_trainer(jax_run, port_run):
    """The adapters after the epoch (3 clipped updates) equal the JAX
    trainer's; every frozen leaf is the JAX initial tree's, bit for bit."""
    final = dict(_flat_jax(jax_run["final"]))
    init = dict(_flat_jax(jax_run["init"]))
    got = _leaves(port_run["trainer"])
    assert set(got) == set(final)
    moved = 0
    for name, p in got.items():
        if name.startswith("adapter_"):
            np.testing.assert_allclose(p.numpy(), final[name], rtol=0, atol=2e-5, err_msg=name)
            moved += not np.array_equal(final[name], init[name])
        else:
            np.testing.assert_array_equal(p.numpy(), init[name], err_msg=name)
    assert moved == 4


def test_first_norm_is_over_every_leaf(corpus, jax_run, port_run):
    """The first update's clipping norm is that of the mean gradient of every
    leaf (frozen ones included) over its two micro-steps, as jax.grad of the
    JAX trainer's loss gives it; the norm binds (above ``CLIP_NORM``) and the
    adapters' share alone would read lower."""
    import jax
    import jax.numpy as jnp

    from summer_clip_tpu.apps.train_gpt import lm_loss_fn

    jt = jax_run["trainer"]
    order = np.random.default_rng((int(jt.cfg.meta.random_state), 1)).permutation(
        len(jt.train_tokens))
    params = jax.tree_util.tree_map(jnp.asarray, jax_run["init"])

    def loss_of(p, ids):
        return lm_loss_fn(jt.model.apply({"params": p}, ids)["logits"], ids)

    grads = [jax.grad(loss_of)(params, jnp.asarray(jt.train_tokens[order[i * 4:(i + 1) * 4]]))
             for i in range(2)]
    mean = jax.tree_util.tree_map(lambda a, b: (np.asarray(a) + np.asarray(b)) / 2, *grads)
    flat = dict(_flat_jax(mean))
    full = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in flat.values())))
    adapters = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                 for n, g in flat.items() if n.startswith("adapter_"))))
    norm = port_run["norms"][0]
    print(f"first update's norm: every leaf {full:.6f}, adapters {adapters:.6f}, port {norm:.6f}")
    np.testing.assert_allclose(norm, full, rtol=1e-5)
    assert norm > CLIP_NORM > adapters, (norm, adapters)


@pytest.mark.parametrize("train_full", [False, True])
def test_frozen_leaves_do_not_move(corpus, train_full):
    """Adapters-only: the core and ``clip_emb`` stay bit for bit; full mask:
    ``clip_emb`` stays and every other leaf moves."""
    from summer_clip_torch.models.gpt2 import (clip_gpt_full_trainable_mask,
                                               clip_gpt_trainable_mask)

    root, data = corpus
    run_dir = root / f"frozen_{train_full}"
    run_dir.mkdir()
    with _Chdir(run_dir):
        pt = _port_trainer(data + [f"clip_gpt.train_full={str(train_full).lower()}"])
        before = _leaves(pt)
        pt.train_loop()
    mask = clip_gpt_full_trainable_mask if train_full else clip_gpt_trainable_mask
    for name, p in _leaves(pt).items():
        if mask(tuple(name.split("."))):
            assert not torch.equal(p, before[name]), name
        else:
            assert torch.equal(p, before[name]), name


def test_checkpoint_reloads_through_gen_gpt(corpus):
    """The step checkpoint (trainable subset + ``init_seed``) rebuilds the
    trained model through ``gen_gpt.load_pretrained_clip_gpt``, leaf for leaf;
    the last eval step carries the optimizer."""
    from summer_clip_torch.apps.gen_gpt import load_pretrained_clip_gpt

    root, data = corpus
    run_dir = root / "reload"
    run_dir.mkdir()
    with _Chdir(run_dir):
        pt = _port_trainer(data)
        pt.train_loop()
    step_dir = run_dir / "checkpoints" / "epoch_1" / "step_7"
    assert (step_dir / "optimizer.ckpt").exists()
    model = load_pretrained_clip_gpt(step_dir, pt.tokenizer, seed=123, device="cpu")
    got = dict(model.named_parameters())
    for name, p in _leaves(pt).items():
        assert torch.equal(got[name], p), name


def test_preempted_run_resumes_exactly(corpus):
    """A run cut after 3 micro-steps (an odd count: the accumulator holds one
    gradient) writes ``step_3_preempt`` with its optimizer and a ``preempted``
    record; a trainer resumed from it (``pretrained.model`` /
    ``pretrained.optimizer``) over the remaining batches ends on the uncut
    run's parameters bit for bit."""
    import json

    root, data = corpus
    run_dir = root / "preempt"
    run_dir.mkdir()
    with _Chdir(run_dir):
        whole = _port_trainer(data)
        whole.train_loop()
        cut = _port_trainer(data)
        calls = []
        cut.preempted = lambda: calls.append(1) or len(calls) >= 3
        cut.train_epoch(1, __import__("summer_clip_torch.core.log_utils",
                                      fromlist=["x"]).StreamingMeans())
        ckpt_dir = run_dir / "checkpoints" / "epoch_1" / "step_3_preempt"
        assert (ckpt_dir / "optimizer.ckpt").exists()
        recs = [json.loads(line) for line in (run_dir / "records.jsonl").read_text().splitlines()]
        assert {"type": "preempted", "epoch": 1, "step": 3} in recs
        resumed = _port_trainer(data + [f"pretrained.model={ckpt_dir}",
                                        "pretrained.optimizer=true"])
    assert resumed.tx.calls == 3 and resumed.tx.count == 1
    assert resumed.tx._acc is not None
    order = np.random.default_rng((int(resumed.cfg.meta.random_state), 1)).permutation(
        len(resumed.train_tokens))
    for step in range(4, 8):
        resumed.train_step(torch.from_numpy(resumed.train_tokens[order[(step - 1) * 4:step * 4]]))
    want = _leaves(whole)
    for name, p in _leaves(resumed).items():
        assert torch.equal(p, want[name]), name


@pytest.mark.parametrize("policy", [None, "dots"])
def test_remat_gives_the_same_losses_and_gradients(policy):
    """remat on (whole block, or the ``dots`` policy) against off: the same
    loss and every leaf's gradient, bit for bit on the CPU."""
    from summer_clip_torch.apps.train_gpt import lm_loss_fn
    from summer_clip_torch.models import gpt2 as G

    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 300, (2, 12)))

    def grads(remat):
        model = G.ClipGPT(G.GPT2_CONFIGS["test-gpt"], clip_vocab_size=300, clip_emb_dim=16,
                          emb_hid_dim=16, head_hid_dim=16, remat=remat, remat_policy=policy)
        model.init_weights(torch.Generator().manual_seed(0)).requires_grad_(True)
        loss = lm_loss_fn(model(ids)["logits"], ids)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in model.named_parameters()}

    (l0, g0), (l1, g1) = grads(False), grads(True)
    assert torch.equal(l0, l1)
    assert set(g0) == set(g1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_dots_policy_saves_only_dense_products():
    """The ``dots`` policy keeps ``aten.mm`` / ``aten.addmm`` outputs and
    recomputes everything else: the batched attention products and any
    buffer a kernel writes into (``empty`` / ``empty_like``)."""
    from torch.utils.checkpoint import CheckpointPolicy

    from summer_clip_torch.models.gpt2 import _dots_policy

    aten = torch.ops.aten
    assert _dots_policy(None, aten.mm.default) == CheckpointPolicy.MUST_SAVE
    assert _dots_policy(None, aten.addmm.default) == CheckpointPolicy.MUST_SAVE
    for op in (aten.bmm.default, aten.empty_like.default, aten.empty.memory_format,
               aten._softmax.default, aten.gelu.default):
        assert _dots_policy(None, op) == CheckpointPolicy.PREFER_RECOMPUTE, op


@pytest.mark.parametrize("kind", ["synthetic", "text_files"])
def test_tokenize_dataset_equals_the_jax_app(tmp_path, kind):
    """``tokenize_texts`` and ``run`` give the JAX app's (N, max_length)
    int32 matrix bit for bit, on the synthetic corpus and on a directory of
    text files."""
    from summer_clip_tpu.apps import tokenize_dataset as jtd
    from summer_clip_tpu.models.tokenizer import get_tokenizer as jtok

    from summer_clip_torch.apps import tokenize_dataset as ptd
    from summer_clip_torch.models.tokenizer import get_tokenizer

    args = ["max_length=12", "hydra.job.chdir=false"]
    if kind == "text_files":
        texts = tmp_path / "texts"
        texts.mkdir()
        for i, text in enumerate(["a photo of a cat on the red car. " * 7,
                                  "the small dog, in a large tree!" * 3, "short"]):
            (texts / f"{i}.txt").write_text(text)
        args += ["source.kind=text_files", f"source.root={texts}"]
    else:
        args += ["source.n_docs=5"]
    with _Chdir(tmp_path):
        jtd.run(argv=args + [f"output_path={tmp_path}/j.npy"])
        ptd.run(argv=args + [f"output_path={tmp_path}/p.npy"])
    want, got = np.load(tmp_path / "j.npy"), np.load(tmp_path / "p.npy")
    assert got.dtype == np.int32 and got.shape[1] == 12 and got.shape[0] > 2
    np.testing.assert_array_equal(got, want)
    from summer_clip_torch.core.config import ConfigNode

    docs = list(ptd.iter_corpus_texts(ConfigNode({"kind": kind, "n_docs": 5,
                                                  "root": str(tmp_path / "texts")})))
    np.testing.assert_array_equal(ptd.tokenize_texts(docs, get_tokenizer(), 12, drop_last=False),
                                  jtd.tokenize_texts(docs, jtok(), 12, drop_last=False))


# --------------------------------------------------------------------------- #
# the heads' f32 output and the optimizer's saved state
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["clip_gpt", "gpt2"])
def test_bf16_logits_are_the_f32_product_of_the_bf16_operands(kind):
    """At bf16 the logits are the bf16 operands' product accumulated and
    returned in f32 (the JAX package's ``preferred_element_type=f32``): not
    confined to bf16 values, and within 1e-6 relative of that product."""
    from summer_clip_torch.models import gpt2 as G

    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 300, (2, 10)))
    if kind == "clip_gpt":
        model = G.ClipGPT(G.GPT2_CONFIGS["test-gpt"], clip_vocab_size=300, clip_emb_dim=16,
                          emb_hid_dim=16, head_hid_dim=16, dtype=torch.bfloat16)
    else:
        model = G.GPT2(G.GPT2_CONFIGS["test-gpt"], dtype=torch.bfloat16)
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = model(ids)
        table = (model.lm_head_table() if kind == "clip_gpt" else model.wte.embedding
                 ).to(torch.bfloat16)
        want = out["hidden"].float() @ table.float().t()
    got = out["logits"]
    assert got.dtype == torch.float32 and out["hidden"].dtype == torch.bfloat16
    assert not torch.equal(got, got.to(torch.bfloat16).float())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))


def test_grad_accum_state_round_trips_through_a_checkpoint(tmp_path):
    """``GradAccum`` / ``Optimizer`` ``state_dict`` -> ``optimizer.ckpt`` ->
    ``load_state_dict`` into a fresh optimizer after an odd number of
    micro-steps: the call count, the update count, the running mean and
    Adam's moments come back, so the two optimizers' next updates are equal
    bit for bit."""
    from summer_clip_torch.engine import checkpoint as ckpt
    from summer_clip_torch.engine.optim import adamw, with_grad_accum

    def build():
        w = torch.nn.Parameter(torch.arange(6, dtype=torch.float32).reshape(2, 3) / 7)
        return w, with_grad_accum(adamw({"w": w}, 0.1, weight_decay=0.1, grad_clip_norm=0.5), 2)

    def micro(w, tx, k):
        (w * (k + 1)).sum().backward()
        tx.step()
        tx.zero_grad()

    w0, tx0 = build()
    for k in range(3):
        micro(w0, tx0, k)
    ckpt.save_checkpoint(tmp_path, opt_state=tx0.state_dict())
    w1, tx1 = build()
    with torch.no_grad():
        w1.copy_(w0)
    tx1.load_state_dict(ckpt.load_pytree(tmp_path / "optimizer.ckpt"))
    assert (tx1.calls, tx1.count) == (3, 1)
    assert torch.equal(tx1._acc[0], tx0._acc[0])
    micro(w0, tx0, 3)
    micro(w1, tx1, 3)
    assert torch.equal(w0, w1)
    assert tx1.inner.last_grad_norm == tx0.inner.last_grad_norm


def test_frozen_leaves_count_in_the_norm_but_never_move(tmp_path):
    """``adamw(..., frozen=...)``: a frozen leaf's gradient is accumulated and
    clipped with the rest (optax's clip outside ``multi_transform``), and the
    leaf stays; ``load_checkpoint(..., opt_target=)`` restores the state."""
    from summer_clip_torch.engine import checkpoint as ckpt
    from summer_clip_torch.engine.optim import adamw, with_grad_accum

    w = torch.nn.Parameter(torch.ones(3))
    f = torch.nn.Parameter(torch.ones(4))
    tx = with_grad_accum(adamw({"w": w}, 0.1, grad_clip_norm=0.5, frozen=[f]), 2)
    for k in range(2):
        (w.sum() + 10 * (k + 1) * f.sum()).backward()
        tx.step()
        tx.zero_grad()
    # the mean gradient: w 1 each, f 15 each -> norm sqrt(3 + 4 * 225)
    assert tx.inner.last_grad_norm == pytest.approx(float(np.sqrt(3 + 4 * 225)), rel=1e-6)
    assert torch.equal(f, torch.ones(4)) and not torch.equal(w, torch.ones(3))
    assert f.grad is None
    ckpt.save_checkpoint(tmp_path, opt_state=tx.state_dict())
    w2 = torch.nn.Parameter(w.detach().clone())
    tx2 = with_grad_accum(adamw({"w": w2}, 0.1, grad_clip_norm=0.5,
                                frozen=[torch.nn.Parameter(torch.ones(4))]), 2)
    ckpt.load_checkpoint(tmp_path, opt_target=tx2)
    assert (tx2.calls, tx2.count, tx2._acc) == (2, 1, None)
    state = tx2.inner.optimizer.state[w2]
    assert torch.equal(state["exp_avg"], tx.inner.optimizer.state[w]["exp_avg"])


def test_clip_checkpoint_path_imports_the_token_table(corpus, tmp_path):
    """``clip_gpt.clip_checkpoint_path``: the CLIP token table of a converted
    checkpoint becomes ``clip_emb`` (the JAX app's import)."""
    from summer_clip_torch.models.clip import build_clip, to_openai_state_dict

    clip, _ = build_clip("test-vit", torch.Generator().manual_seed(7), device="cpu")
    torch.save(to_openai_state_dict(clip), tmp_path / "clip.pt")
    root, data = corpus
    with _Chdir(tmp_path):
        pt = _port_trainer(data + ["clip_gpt.clip_emb_dim=32",
                                   f"clip_gpt.clip_checkpoint_path={tmp_path / 'clip.pt'}"])
    assert torch.equal(pt.model.clip_emb.detach(), clip.token_embedding.weight)
