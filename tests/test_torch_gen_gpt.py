"""``summer_clip_torch.apps.gen_gpt`` against ``summer_clip_tpu.apps.gen_gpt``.

Both packages run the same numbers (the JAX variables carried across as numpy,
the int8 tree leaf by leaf). ``jax.random.categorical`` cannot be reproduced
with a ``torch.Generator``, so what is held is: greedy (``top_k=1``) ids equal
the JAX package's, solo and batched, f32 and int8; ``_filter_logits`` keeps the
same token set; within the port the host loop and the device loop give the same
ids from one seed; rows of the batched sampler equal solo greedy runs.
"""

import json
import types

import numpy as np
import pytest
import torch
import yaml

from summer_clip_torch.apps import gen_gpt as tgen
from summer_clip_torch.engine.quant import quantize_tree
from summer_clip_torch.models import gpt2 as tg
from summer_clip_torch.ops import gemv

CLIP_KW = dict(clip_vocab_size=300, clip_emb_dim=16, emb_hid_dim=24, head_hid_dim=24)


def make_pair(kind: str, config: str, quant: bool = False, **clip_kw):
    """(JAX model, JAX variables, port model) on the same numbers."""
    import jax

    from summer_clip_tpu.engine.quant import quantize_tree as jquantize
    from summer_clip_tpu.models import gpt2 as jg

    cfg = jg.GPT2_CONFIGS[config]
    kw = {**CLIP_KW, **clip_kw}
    jm = jg.GPT2(cfg) if kind == "gpt2" else jg.ClipGPT(cfg, **kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), np.zeros((1, 4), np.int32))["params"]
    if quant:
        params = jquantize(params)
    tcfg = tg.GPT2_CONFIGS[config]
    tm = tg.GPT2(tcfg) if kind == "gpt2" else tg.ClipGPT(tcfg, **kw)
    tm.load_tree(tg.from_flax_variables(jax.tree_util.tree_map(np.asarray, jax.device_get(params))))
    return jm, {"params": params}, tm.eval()

PROMPTS = [[3, 14, 15], [7], [9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8, 4, 6, 2]]


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("kind", ["gpt2", "clip_gpt"])
def test_greedy_ids_equal_the_jax_packages_solo_and_batched(kind, quant):
    """Width 256 (test-gpt-mega): on the int8 tree every decode step is
    tile-legal, so the JAX side streams through K7 in interpret mode."""
    from summer_clip_tpu.apps import gen_gpt as jgen

    jm, jv, tm = make_pair(kind, "test-gpt-mega", quant=quant)
    kw = dict(max_new_tokens=6, top_k=1, quant_int8=quant)
    for prompt in PROMPTS[:2]:
        want = jgen.generate_device(jm, jv, prompt, **kw)
        got = tgen.generate_device(tm, prompt, **kw)
        assert got == want, (prompt, got, want)
    want = jgen.generate_device_batched(jm, jv, PROMPTS, **kw)
    got = tgen.generate_device_batched(tm, PROMPTS, **kw)
    assert got == want
    for prompt, row in zip(PROMPTS, got):
        assert row == tgen.generate_device(tm, prompt, **kw)


def test_int8_decode_steps_go_through_k7_and_the_fused_mlp_opt_in(monkeypatch):
    """The routing of one int8 decode step, counted at the wrappers' plain
    versions: 4 products a block + 2 adapters + the head; with the opt-in the
    MLP pair leaves K7 for K10."""
    _, _, tm = make_pair("clip_gpt", "test-gpt-mega", quant=True,
                         clip_emb_dim=128, emb_hid_dim=128, head_hid_dim=128)
    calls = {"k7": 0, "k10": 0}
    real7, real10 = gemv.streamed_qmatmul, gemv.fused_qmlp

    def k7(*a, **k):
        calls["k7"] += 1
        return real7(*a, **k)

    def k10(*a, **k):
        calls["k10"] += 1
        return real10(*a, **k)

    monkeypatch.setattr(gemv, "streamed_qmatmul", k7)
    monkeypatch.setattr(gemv, "fused_qmlp", k10)
    layers = tm.config.n_layer
    plain = tgen.generate_device(tm, [3, 14, 15], max_new_tokens=4, top_k=1, quant_int8=True)
    # prefill (3 rows) and 3 decode forwards: 4 per block + 2 adapters, and 3 head reads
    assert calls == {"k7": 4 * (4 * layers + 2) + 3, "k10": 0}
    calls.update(k7=0, k10=0)
    monkeypatch.setenv("SUMMER_CLIP_FUSED_MLP", "1")
    fused = tgen.generate_device(tm, [3, 14, 15], max_new_tokens=4, top_k=1, quant_int8=True)
    assert calls == {"k7": 4 * (2 * layers + 2) + 3, "k10": 4 * layers}
    assert fused == plain or len(fused) == len(plain)   # the hidden is rounded once less
    calls.update(k7=0, k10=0)
    monkeypatch.setenv("SUMMER_CLIP_GEMV", "0")
    tgen.generate_device(tm, [3, 14, 15], max_new_tokens=4, top_k=1, quant_int8=True)
    assert calls == {"k7": 0, "k10": 0}


@pytest.mark.parametrize("top_k,top_p", [(8, 1.0), (8, 0.6), (0, 0.5), (50, 0.95), (1, 1.0)])
def test_filter_logits_keeps_the_jax_packages_token_set(top_k, top_p):
    import jax.numpy as jnp

    from summer_clip_tpu.apps import gen_gpt as jgen

    logits = (np.random.default_rng(top_k).standard_normal((3, 200)) * 3).astype(np.float32)
    jv, ji = jgen._filter_logits(jnp.asarray(logits), top_k, False, top_p)
    tv, ti = tgen._filter_logits(torch.from_numpy(logits), top_k, top_p)
    jv, ji, tv, ti = np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()
    for r in range(3):
        assert set(ji[r][np.isfinite(jv[r])]) == set(ti[r][np.isfinite(tv[r])])
    np.testing.assert_array_equal(ji, ti)


@pytest.mark.parametrize("kwargs", [{"top_k": 8}, {"top_k": 0}, {"top_k": 8, "temperature": 0.7},
                                    {"top_k": 4, "eot_id": 7}, {"top_k": 8, "top_p": 0.6},
                                    {"top_k": 0, "top_p": 0.5}])
def test_host_loop_equals_device_loop_under_one_seed(kwargs):
    _, _, tm = make_pair("gpt2", "test-gpt")
    host = tgen.generate(tm, [3, 14, 15], max_new_tokens=12,
                         generator=torch.Generator().manual_seed(42), **kwargs)
    dev = tgen.generate_device(tm, [3, 14, 15], max_new_tokens=12,
                               generator=torch.Generator().manual_seed(42), **kwargs)
    assert host == dev, (kwargs, host, dev)


def test_vanishing_nucleus_is_greedy_and_eot_cuts():
    _, _, tm = make_pair("gpt2", "test-gpt")
    nuc = tgen.generate_device(tm, [3, 14, 15], max_new_tokens=12, top_k=8, top_p=1e-6,
                               generator=torch.Generator().manual_seed(3))
    greedy = tgen.generate_device(tm, [3, 14, 15], max_new_tokens=12, top_k=1)
    assert nuc == greedy
    cut = tgen.generate_device(tm, [3, 14, 15], max_new_tokens=12, top_k=1, eot_id=greedy[5])
    assert cut == greedy[:greedy.index(greedy[5], 3) + 1]
    with pytest.raises(ValueError, match="positions"):
        tgen.generate_device(tm, [1] * 90, max_new_tokens=12)
    with pytest.raises(ValueError, match="geometry"):   # width 32: not a megakernel geometry
        tgen.generate_device(tm, [1], megakernel=True)


def _checkpoint(tmp_path, seed=5, gpt_config="test-gpt", name="ckpt"):
    model_cfg = {"gpt_config": gpt_config, "clip_emb_dim": 16,
                 "adapters": {"emb_hid_dim": 24, "head_hid_dim": 24}}
    vocab = tgen.get_tokenizer().vocab_size
    model = tgen.build_clip_gpt(model_cfg, vocab, seed, device="cpu")
    with torch.no_grad():   # "trained" adapters: not what the seed gives
        model.adapter_emb.fc1.kernel.mul_(1.5)
    return tgen.save_clip_gpt_checkpoint(tmp_path / name, model, model_cfg, seed, step=3), model


def test_checkpoint_holds_the_trainable_subset_and_rebuilds_the_model(tmp_path):
    from summer_clip_torch.engine import checkpoint as ckpt

    path, model = _checkpoint(tmp_path)
    assert path.name == "step_3"
    loaded = ckpt.load_checkpoint(path)
    assert set(loaded["params"]) == {"adapter_emb", "adapter_head"}
    assert loaded["meta"] == {"model_cfg": loaded["meta"]["model_cfg"], "init_seed": 5}
    again = tgen.load_pretrained_clip_gpt(path, tgen.get_tokenizer(), seed=99, device="cpu")
    for (n1, a), (n2, b) in zip(model.named_parameters(), again.named_parameters()):
        assert n1 == n2 and torch.equal(a, b), n1
    merged = ckpt.merge_tree({"a": {"b": 1, "c": 2}, "d": 3}, {"a": {"b": 7}})
    assert merged == {"a": {"b": 7, "c": 2}, "d": 3}
    qtree = quantize_tree(again.tree())
    ckpt.save_pytree(tmp_path / "q.ckpt", ckpt.filter_tree(again.tree(), lambda p: p[0] == "core"))
    assert set(ckpt.load_pytree(tmp_path / "q.ckpt")) == {"core"}
    assert gemv.is_qleaf(qtree["clip_emb"])


def test_entry_points_pick_the_card_and_draw_weights_on_the_cpu(tmp_path, monkeypatch):
    """Without a ``device`` the model goes where ``resolve_device`` says (the
    card when there is one); the weights are a CPU generator's whatever the
    device, so the checkpoint's seed alone determines the frozen leaves."""
    asked = []

    def fake_resolve(name=None):
        asked.append(name)
        return torch.device("cpu")

    monkeypatch.setattr(tgen, "resolve_device", fake_resolve)
    path, model = _checkpoint(tmp_path)
    again = tgen.load_pretrained_clip_gpt(path, tgen.get_tokenizer())
    assert None in asked and torch.equal(again.clip_emb, model.clip_emb)
    with pytest.raises(ValueError, match="CPU generator"):
        model.init_weights(types.SimpleNamespace(device=torch.device("cuda")))


@pytest.mark.cuda
def test_cuda_build_gives_the_cpu_builds_weights():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = {"gpt_config": "test-gpt-mega", "clip_emb_dim": 16,
           "adapters": {"emb_hid_dim": 24, "head_hid_dim": 24}}
    on_card, on_cpu = tgen.build_clip_gpt(cfg, 512, 7), tgen.build_clip_gpt(cfg, 512, 7, device="cpu")
    assert on_card.clip_emb.is_cuda
    for (n1, a), (n2, b) in zip(on_card.named_parameters(), on_cpu.named_parameters()):
        assert n1 == n2 and torch.equal(a.cpu(), b), n1


def _records(root):
    out = []
    for p in sorted(root.rglob("records.jsonl")):
        out.extend(json.loads(line) for line in p.read_text().splitlines())
    return out


def test_app_end_to_end_writes_results(tmp_path, monkeypatch):
    path, _ = _checkpoint(tmp_path)
    np.save(tmp_path / "val.npy", np.random.default_rng(0).integers(0, 49408, (8, 16)))
    monkeypatch.chdir(tmp_path)
    common = [f"model.checkpoint_dir={path}", "generation.max_new_tokens=4", "meta.device=cpu"]
    tgen.run(argv=common + [f"val.tokens_path={tmp_path}/val.npy", "batch_size=4",
                            "generation.top_p=0.9", "generation.num_return_sequences=2",
                            'prompts=["a photo of"]'])
    gens = [r for r in _records(tmp_path) if r.get("type") == "generation"]
    assert len(gens) == 2 and [g["sample"] for g in gens] == [0, 1]
    ppl = [r for r in _records(tmp_path) if r.get("type") == "gpt_perplexity"]
    assert len(ppl) == 1 and np.isfinite(ppl[0]["perplexity"]) and ppl[0]["perplexity"] > 1
    results = yaml.safe_load(sorted(tmp_path.rglob("results.yaml"))[-1].read_text())
    n_prompt = 1 + len(tgen.get_tokenizer().encode("a photo of"))
    assert len(results["generations"]) == 2
    assert n_prompt < len(results["generations"][0]["ids"]) <= n_prompt + 4

    outs = {}
    for name, extra in {"device": [], "host": ["generation.device_loop=false"],
                        "batched": ["generation.batched=true"],
                        "int8": ["generation.quant_int8=true"],
                        "int8_batched": ["generation.quant_int8=true", "generation.batched=true"]
                        }.items():
        before = len(_records(tmp_path))
        tgen.run(argv=common + ["generation.top_k=1", 'prompts=["a photo of","a"]'] + extra)
        outs[name] = [r["text"] for r in _records(tmp_path)[before:] if r.get("type") == "generation"]
        assert len(outs[name]) == 2
    assert outs["device"] == outs["host"] == outs["batched"]
    assert outs["int8"] == outs["int8_batched"]


@pytest.mark.parametrize("override,match", [
    ("generation.tp=2", "tensor-parallel")])
def test_switches_not_ported_yet_raise(tmp_path, monkeypatch, override, match):
    path, _ = _checkpoint(tmp_path)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=match):
        tgen.run(argv=[f"model.checkpoint_dir={path}", "meta.device=cpu", override,
                       'prompts=["a"]'])


SERVING_SWITCHES = {
    # name: (overrides, the run whose greedy ids it must equal or None)
    "continuous": (["generation.continuous=true", "generation.batch_slots=2"], "device"),
    "continuous_legacy": (["generation.continuous=true", "generation.wave=false",
                           "generation.burst=1"], "device"),
    "continuous_int8_megakernel": (["generation.continuous=true", "generation.quant_int8=true",
                                    "generation.megakernel=true", "generation.batch_slots=2"],
                                   "int8_megakernel"),
    "speculative": (["generation.speculative=true", "generation.speculative_k=3"], "device"),
    # the speculative arm ignores quant_int8, as the JAX app does
    "speculative_int8": (["generation.speculative=true", "generation.quant_int8=true"], "device"),
    "megakernel_bf16": (["generation.megakernel=true"], None),
    "int8_megakernel": (["generation.quant_int8=true", "generation.megakernel=true"], None),
    "int8_megakernel_batched": (["generation.quant_int8=true", "generation.megakernel=true",
                                 "generation.batched=true"], "int8_megakernel"),
}


@pytest.fixture(scope="module")
def serving_app(tmp_path_factory):
    """A target (width 256: a megakernel geometry) and a draft checkpoint, and
    a function that runs the app on the CPU and returns ``results.yaml``."""
    root = tmp_path_factory.mktemp("serving_app")
    target, _ = _checkpoint(root, gpt_config="test-gpt-mega")
    draft, _ = _checkpoint(root, seed=6, gpt_config="test-gpt", name="draft")
    cache = {}

    def run(name, extra):
        if name not in cache:
            import os

            work = root / name
            work.mkdir()
            cwd = os.getcwd()
            os.chdir(work)
            try:
                tgen.run(argv=[f"model.checkpoint_dir={target}", "meta.device=cpu",
                               "generation.max_new_tokens=5", "generation.top_k=1",
                               f"generation.draft_checkpoint_dir={draft}",
                               'prompts=["a photo of","a","this is"]'] + extra)
            finally:
                os.chdir(cwd)
            cache[name] = yaml.safe_load(sorted(work.rglob("results.yaml"))[-1].read_text())
        return cache[name]

    return run


@pytest.mark.parametrize("name", sorted(SERVING_SWITCHES))
def test_serving_switches_run_through_the_app(serving_app, name):
    """``continuous``, ``speculative`` and ``megakernel=true`` through
    ``gen_gpt.run`` on the CPU: every prompt gets its continuation in
    ``results.yaml``, and greedy ids equal the route they must equal (an engine
    or a speculative run the device loop; megakernel routes one another)."""
    extra, same_as = SERVING_SWITCHES[name]
    results = serving_app(name, extra)
    tok = tgen.get_tokenizer()
    prompts = ["a photo of", "a", "this is"]
    gens = results["generations"]
    assert [g["prompt"] for g in gens] == prompts
    for g, p in zip(gens, prompts):
        n_prompt = 1 + len(tok.encode(p))
        assert g["ids"][:n_prompt] == [tok.sot_token] + tok.encode(p)
        assert len(g["ids"]) == n_prompt + 5 or g["ids"][-1] == tok.eot_token
    if same_as is not None:
        other = serving_app(same_as, [] if same_as == "device" else SERVING_SWITCHES[same_as][0])
        assert [g["ids"] for g in gens] == [g["ids"] for g in other["generations"]]


def test_perplexity_matches_the_jax_loss():
    import jax.numpy as jnp

    from summer_clip_tpu.apps.train_gpt import lm_loss_fn as jloss
    from summer_clip_torch.apps.train_gpt import lm_loss_fn

    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 9, 50)).astype(np.float32)
    ids = rng.integers(0, 50, (2, 9)).astype(np.int32)
    want = float(jloss(jnp.asarray(logits), jnp.asarray(ids)))
    got = float(lm_loss_fn(torch.from_numpy(logits), torch.from_numpy(ids)))
    assert abs(got - want) < 1e-5
