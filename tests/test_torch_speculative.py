"""``summer_clip_torch.engine.speculative`` against the JAX package.

Speculation must never change tokens, only how many target forwards they cost:
the port's ``generate_device_speculative`` is held to the JAX package's on
weights carried across (weak draft at k = 1, 3, 5; the target as its own draft;
eot; int8 trees, whose draft steps and verify forward stream through K7), to the
JAX package's solo greedy sampler and to the port's own. Ids are compared
exactly: on the CPU at these sizes a row's logits do not depend on how many
positions share a forward.
"""

import numpy as np
import pytest
import torch

from summer_clip_torch.apps import gen_gpt as tgen
from summer_clip_torch.engine.quant import quantize_tree
from summer_clip_torch.engine.speculative import generate_device_speculative
from summer_clip_torch.models import gpt2 as tg
from summer_clip_torch.ops import gemv

PROMPT = [3, 17, 101, 9]


def _build(seed, **overrides):
    """(JAX model, variables, port model) of ``test-gpt`` from one JAX seed."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from summer_clip_tpu.models import gpt2 as jg

    cfg = dataclasses.replace(jg.GPT2_CONFIGS["test-gpt"], **overrides)
    jm = jg.GPT2(cfg)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    tm = tg.GPT2(dataclasses.replace(tg.GPT2_CONFIGS["test-gpt"], **overrides))
    tm.load_tree(tg.from_flax_variables(jax.tree_util.tree_map(np.asarray, jax.device_get(params))))
    return jm, {"params": params}, tm.eval()


@pytest.fixture(scope="module")
def models():
    from summer_clip_tpu.apps import gen_gpt as jgen

    target, draft = _build(0), _build(7, n_embd=16, n_layer=1)
    solo = jgen.generate_device(target[0], target[1], PROMPT, max_new_tokens=16, top_k=1)
    assert tgen.generate_device(target[2], PROMPT, max_new_tokens=16, top_k=1) == solo
    return {"target": target, "draft": draft, "solo": solo}


@pytest.mark.parametrize("k", [1, 3, 5])
def test_weak_draft_never_changes_the_output(models, k):
    """A draft with other weights and a smaller tower: acceptance only keeps
    tokens that the target agrees with."""
    from summer_clip_tpu.engine.speculative import generate_device_speculative as jspec

    (jt, jtv, tt), (jd, jdv, td) = models["target"], models["draft"]
    want, jstats = jspec(jt, jtv, jd, jdv, PROMPT, max_new_tokens=16, k=k, return_stats=True)
    got, stats = generate_device_speculative(tt, td, PROMPT, max_new_tokens=16, k=k,
                                             return_stats=True)
    assert got == want == models["solo"]
    assert stats == jstats


@pytest.mark.parametrize("k", [3, 4])
def test_perfect_draft_accepts_every_window(models, k):
    """The target as its own draft: 16 tokens need ceil(16 / (k + 1)) verify
    forwards (a draft that lost its prefilled cache would need 16)."""
    _, _, tt = models["target"]
    got, stats = generate_device_speculative(tt, tt, PROMPT, max_new_tokens=16, k=k,
                                             return_stats=True)
    assert got == models["solo"]
    assert stats["verify_iters"] == -(-16 // (k + 1)), stats
    assert stats["emitted"] >= 16


def test_eot_cuts_like_the_solo_sampler(models):
    from summer_clip_tpu.engine.speculative import generate_device_speculative as jspec

    (jt, jtv, tt), (jd, jdv, td) = models["target"], models["draft"]
    eot = models["solo"][len(PROMPT) + 3]     # the 4th generated token as a fake eot
    solo = tgen.generate_device(tt, PROMPT, max_new_tokens=16, top_k=1, eot_id=eot)
    got = generate_device_speculative(tt, td, PROMPT, max_new_tokens=16, k=4, eot_id=eot)
    assert got == solo == jspec(jt, jtv, jd, jdv, PROMPT, max_new_tokens=16, k=4, eot_id=eot)
    assert got[-1] == eot and len(got) <= len(PROMPT) + 4


def test_int8_trees_give_the_solo_int8_decode(models, monkeypatch):
    """int8 target and int8 draft, consumed as stored: the draft's one-row steps
    and the (k + 1)-row verify forward are decode-shaped (K7's route), the heads
    read two int8 tables built once."""
    from summer_clip_tpu.apps import gen_gpt as jgen
    from summer_clip_tpu.engine.quant import quantize_tree as jquantize
    from summer_clip_tpu.engine.speculative import generate_device_speculative as jspec

    (jt, jtv, tt), (jd, jdv, td) = models["target"], models["draft"]
    qt, qd = {"params": jquantize(jtv["params"])}, {"params": jquantize(jdv["params"])}
    tq = tt.with_tree(quantize_tree(tt.tree())).eval()
    dq = td.with_tree(quantize_tree(td.tree())).eval()
    solo = jgen.generate_device(jt, qt, PROMPT, max_new_tokens=12, top_k=1, quant_int8=True)
    want = jspec(jt, qt, jd, qd, PROMPT, max_new_tokens=12, k=3, quant_int8=True,
                 draft_quant_int8=True)
    rows = []
    real = gemv.qdot
    monkeypatch.setattr("summer_clip_torch.engine.speculative.qdot",
                        lambda x, leaf, dtype: rows.append(x.shape[0]) or real(x, leaf, dtype))
    got = generate_device_speculative(tq, dq, PROMPT, max_new_tokens=12, k=3, quant_int8=True,
                                      draft_quant_int8=True)
    assert got == want == solo
    assert got == tgen.generate_device(tq, PROMPT, max_new_tokens=12, top_k=1, quant_int8=True)
    assert set(rows) == {1, 4}     # head reads: draft steps of one row, verify of k + 1


def test_budgets_are_checked(models):
    _, _, tt = models["target"]
    _, _, td = models["draft"]
    with pytest.raises(ValueError, match="positions"):
        generate_device_speculative(tt, td, list(range(90)), max_new_tokens=16, k=4)
    with pytest.raises(ValueError, match="at least one"):
        generate_device_speculative(tt, td, PROMPT, k=0)


def _clip_gpt_pair(seed, vocab):
    """(JAX ClipGPT, variables, port ClipGPT) of ``test-gpt`` over the CLIP
    vocabulary from one JAX seed."""
    import jax
    import jax.numpy as jnp

    from summer_clip_tpu.models import gpt2 as jg

    kw = dict(clip_vocab_size=vocab, clip_emb_dim=16, emb_hid_dim=24, head_hid_dim=24)
    jm = jg.ClipGPT(jg.GPT2_CONFIGS["test-gpt"], **kw)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32))["params"]
    tm = tg.ClipGPT(tg.GPT2_CONFIGS["test-gpt"], **kw)
    tm.load_tree(tg.from_flax_variables(jax.tree_util.tree_map(np.asarray, jax.device_get(params))))
    return jm, {"params": params}, tm.eval()


def test_app_speculative_ignores_quant_int8_as_the_jax_app(tmp_path, monkeypatch):
    """``gen_gpt`` with ``generation.speculative=true generation.quant_int8=true``:
    the JAX app decodes both full-precision trees on this arm, and so does the
    port's, so the two apps emit the same ids (and those of the full tree's
    solo greedy sampler)."""
    import yaml

    from summer_clip_tpu.apps import gen_gpt as jgen

    vocab = tgen.get_tokenizer().vocab_size
    # target seed 4: its int8 tree's greedy ids differ from the full tree's
    pairs = {"target": _clip_gpt_pair(4, vocab), "draft": _clip_gpt_pair(0, vocab)}
    monkeypatch.setattr(jgen, "load_pretrained_clip_gpt",
                        lambda path, tok, rng=None: pairs[str(path)][:2])
    monkeypatch.setattr(tgen, "load_pretrained_clip_gpt",
                        lambda path, tok, seed=0, device=None, base=None: pairs[str(path)][2])
    prompts = ["a photo of", "a", "this is"]
    argv = ["model.checkpoint_dir=target", "generation.draft_checkpoint_dir=draft",
            "generation.speculative=true", "generation.quant_int8=true",
            "generation.speculative_k=3", "generation.max_new_tokens=6", "generation.top_k=1",
            f"prompts={prompts}"]
    ids = {}
    for name, app, extra in (("jax", jgen, []), ("port", tgen, ["meta.device=cpu"])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        app.run(argv=argv + extra)
        results = yaml.safe_load(sorted((tmp_path / name).rglob("results.yaml"))[-1].read_text())
        ids[name] = [g["ids"] for g in results["generations"]]
    assert len(ids["port"]) == len(prompts) and ids["port"] == ids["jax"]
    tok, tm = tgen.get_tokenizer(), pairs["target"][2]
    solo = [tgen.generate_device(tm, [tok.sot_token] + tok.encode(p), max_new_tokens=6, top_k=1)
            for p in prompts]
    assert ids["port"] == solo
    # the int8 tree decodes other ids here, so the test tells the two trees apart
    tq = tm.with_tree(quantize_tree(tm.tree())).eval()
    assert solo != [tgen.generate_device(tq, row[:len(row) - 6], max_new_tokens=6, top_k=1,
                                         quant_int8=True) for row in solo]


@pytest.mark.cuda
def test_cuda_int8_speculation_streams_through_k7():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(0)
    target = tg.GPT2(tg.GPT2_CONFIGS["test-gpt-mega"], device="cuda").init_weights(gen).eval()
    tq = target.with_tree(quantize_tree(target.tree())).eval()
    before = gemv.streamed_qmatmul.launches
    got, stats = generate_device_speculative(tq, tq, PROMPT, max_new_tokens=10, k=4,
                                             quant_int8=True, draft_quant_int8=True,
                                             return_stats=True)
    assert gemv.streamed_qmatmul.launches > before
    assert len(got) == len(PROMPT) + 10 and stats["verify_iters"] <= 10
