"""``summer_clip_torch.models.gpt2`` against ``summer_clip_tpu.models.gpt2``.

The JAX model is initialised from a key; its variables go across as numpy
through ``from_flax_variables`` (and a ``quantize_tree`` result leaf by leaf),
so both packages compute on the same numbers. f32 on the CPU in both: logits
agree to 1e-4 (sums in another order). The int8 tree's decode-shaped products
run K7 in Pallas interpret mode on the JAX side and its plain version here.
"""

import numpy as np
import pytest
import torch

from summer_clip_torch.models import gpt2 as tg
from summer_clip_torch.ops.gemv import is_qleaf

TOL = dict(rtol=1e-4, atol=1e-4)
CLIP_KW = dict(clip_vocab_size=300, clip_emb_dim=16, emb_hid_dim=24, head_hid_dim=24)


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def make_pair(kind: str, config: str, quant: bool = False, seed: int = 0, **clip_kw):
    """(JAX model, JAX variables, port model) on the same numbers."""
    import jax

    from summer_clip_tpu.engine.quant import quantize_tree
    from summer_clip_tpu.models import gpt2 as jg

    cfg = jg.GPT2_CONFIGS[config]
    kw = {**CLIP_KW, **clip_kw}
    jm = jg.GPT2(cfg) if kind == "gpt2" else jg.ClipGPT(cfg, **kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), np.zeros((1, 4), np.int32))["params"]
    if quant:
        params = quantize_tree(params)
    tcfg = tg.GPT2_CONFIGS[config]
    tm = tg.GPT2(tcfg) if kind == "gpt2" else tg.ClipGPT(tcfg, **kw)
    tm.load_tree(tg.from_flax_variables(_np_tree(params)))
    return jm, {"params": params}, tm.eval()


def _ids(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _t(ids):
    return torch.from_numpy(np.asarray(ids, np.int64))


def test_configs_equal_the_jax_packages():
    from summer_clip_tpu.models import gpt2 as jg

    assert {k: vars(v) for k, v in tg.GPT2_CONFIGS.items()} == \
        {k: vars(v) for k, v in jg.GPT2_CONFIGS.items()}


@pytest.mark.parametrize("kind,vocab", [("gpt2", 512), ("clip_gpt", 300)])
@pytest.mark.parametrize("config", ["test-gpt", "test-gpt-mega"])
def test_full_forward_logits_match_jax(kind, vocab, config):
    jm, jv, tm = make_pair(kind, config)
    ids = _ids(1, (2, 12), vocab)
    want = jm.apply(jv, ids)
    with torch.no_grad():
        got = tm(_t(ids))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), **TOL)
    np.testing.assert_allclose(got["hidden"].numpy(), np.asarray(want["hidden"]), **TOL)
    assert got["cache"] is None and got["logits"].dtype == torch.float32


def test_shared_head_adapter_has_the_jax_tree_and_logits():
    jm, jv, tm = make_pair("clip_gpt", "test-gpt", head_hid_dim=None)
    assert "adapter_head" not in tm.tree() and "adapter_head" not in jv["params"]
    ids = _ids(2, (1, 7), 300)
    with torch.no_grad():
        got = tm(_t(ids))["logits"].numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(jv, ids)["logits"]), **TOL)


def test_tree_has_the_jax_paths_and_round_trips():
    import jax

    jm, jv, tm = make_pair("clip_gpt", "test-gpt")
    want = {"/".join(str(p.key) for p in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(jv["params"])[0]}

    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                yield "/".join(prefix + (k,)), tuple(v.shape)

    assert dict(flat(tm.tree())) == want
    clone = tm.with_tree(tm.tree())
    assert clone.core.h_0.attn.c_attn.kernel.data_ptr() == tm.core.h_0.attn.c_attn.kernel.data_ptr()
    with pytest.raises(ValueError, match="lacks"):
        tm.with_tree({"clip_emb": tm.clip_emb.data})
    with pytest.raises(ValueError, match="shape"):
        tm.load_tree({"clip_emb": torch.zeros(3, 3)})


@pytest.mark.parametrize("kind,vocab", [("gpt2", 512), ("clip_gpt", 300)])
def test_cached_incremental_equals_full_forward_and_jax(kind, vocab):
    jm, jv, tm = make_pair(kind, "test-gpt")
    ids = _ids(3, (2, 10), vocab)
    with torch.no_grad():
        full = tm(_t(ids))["logits"].numpy()
        cache = tm.init_cache(2, 16)
        out = tm(_t(ids[:, :6]), position_offset=0, cache=cache)
        steps = [out["logits"].numpy()]
        for i in range(6, 10):
            out = tm(_t(ids[:, i:i + 1]), position_offset=i, cache=out["cache"])
            steps.append(out["logits"].numpy())
    assert out["cache"][0]["index"] == 10 and out["cache"][0]["k"] is cache[0]["k"]
    np.testing.assert_allclose(np.concatenate(steps, axis=1), full, **TOL)

    jcache = jm.apply(jv, method=jm.init_cache, batch=2, max_len=16)
    jout = jm.apply(jv, ids[:, :6], position_offset=0, cache=jcache)
    jout = jm.apply(jv, ids[:, 6:7], position_offset=6, cache=jout["cache"])
    np.testing.assert_allclose(steps[1], np.asarray(jout["logits"]), **TOL)


def test_per_row_index_and_key_pad_match_jax():
    import jax.numpy as jnp

    jm, jv, tm = make_pair("clip_gpt", "test-gpt")
    ids = _ids(4, (3, 5), 300)
    idx = np.array([0, 3, 6], np.int32)
    pad = np.array([0, 2, 1], np.int32)

    jcache = jm.apply(jv, method=jm.init_cache, batch=3, max_len=12)
    jcache = [dict(c, index=jnp.asarray(idx)) for c in jcache]
    want = jm.apply(jv, ids, position_offset=jnp.asarray(idx)[:, None], cache=jcache)
    cache = tm.init_cache(3, 12)
    for c in cache:
        c["index"] = torch.from_numpy(idx).long()
    with torch.no_grad():
        got = tm(_t(ids), position_offset=torch.from_numpy(idx).long()[:, None], cache=cache)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), **TOL)
    np.testing.assert_array_equal(got["cache"][0]["index"].numpy(), idx + 5)
    np.testing.assert_allclose(got["cache"][1]["k"].numpy(), np.asarray(want["cache"][1]["k"]), **TOL)

    # left-padded rows: scalar index, key_pad, negative offsets clamped to 0
    jcache = jm.apply(jv, method=jm.init_cache, batch=3, max_len=12)
    want = jm.apply(jv, ids, position_offset=(-jnp.asarray(pad))[:, None], cache=jcache,
                    key_pad=jnp.asarray(pad))
    with torch.no_grad():
        got = tm(_t(ids), position_offset=(-torch.from_numpy(pad).long())[:, None],
                 cache=tm.init_cache(3, 12), key_pad=torch.from_numpy(pad).long())
    assert np.isfinite(got["logits"].numpy()).all()
    np.testing.assert_allclose(got["logits"].numpy()[:, -1], np.asarray(want["logits"])[:, -1], **TOL)


def test_position_clamp_saturates_like_jax():
    jm, jv, tm = make_pair("gpt2", "test-gpt")
    ids = _ids(5, (1, 4), 512)
    want = jm.apply(jv, ids, position_offset=94)          # n_positions = 96
    with torch.no_grad():
        got = tm(_t(ids), position_offset=94)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), **TOL)


@pytest.mark.parametrize("kind,vocab", [("gpt2", 512), ("clip_gpt", 300)])
def test_int8_tree_carried_across_matches_jax(kind, vocab, monkeypatch):
    """Width 256: decode-shaped calls are tile-legal, so the JAX side runs K7
    (interpret mode) and the port its plain version; prefill (12 rows) takes
    the wide route in both. Every int8 product rounds its input to bf16, and
    an input that differs in its last f32 bit may round to the neighbouring
    bf16 value (2^-9 relative), which moves a logit (size ~0.3) by some 1e-4.
    The order of the f32 sums alone does that: the port's plain product summed
    in f64, the same function, is held here too, and it moves the port's own
    logits by up to 4.9e-4 (GPT2 prefill) where the JAX package's lie 1.2e-7
    to 1.2e-4 from the port's. So 1e-3, not the 1e-4 of the f32 tree."""
    from summer_clip_torch.ops import gemv

    jm, jv, tm = make_pair(kind, "test-gpt-mega", quant=True)
    assert is_qleaf(tm.core.h_0.attn.c_attn.kernel) and is_qleaf(tm.core.wpe)
    assert not is_qleaf(tm.core.h_0.ln_1.scale)
    ids = _ids(6, (1, 12), vocab)
    jcache = jm.apply(jv, method=jm.init_cache, batch=1, max_len=16)
    jout = jm.apply(jv, ids, position_offset=0, cache=jcache)
    jstep = jm.apply(jv, ids[:, :1], position_offset=12, cache=jout["cache"])

    def sums_in_f64(x, w, scale=None):
        wide = w.double() if w.dtype == torch.int8 else gemv._round_bf16(w).double()
        y = torch.matmul(gemv._round_bf16(x).double(), wide)
        return (y if scale is None else y * scale.reshape(1, -1).double()).float()

    for tol, plain in ((1e-3, gemv.matmul_reference), (1e-3, sums_in_f64)):
        monkeypatch.setattr(gemv, "matmul_reference", plain)
        with torch.no_grad():
            out = tm(_t(ids), position_offset=0, cache=tm.init_cache(1, 16))
            step = tm(_t(ids[:, :1]), position_offset=12, cache=out["cache"])
        np.testing.assert_allclose(out["logits"].numpy(), np.asarray(jout["logits"]),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(step["logits"].numpy(), np.asarray(jstep["logits"]),
                                   rtol=tol, atol=tol)


def test_compute_logits_false_skips_the_head():
    _, _, tm = make_pair("clip_gpt", "test-gpt")
    with torch.no_grad():
        out = tm(_t(_ids(7, (1, 3), 300)), compute_logits=False)
    assert out["logits"] is None and out["hidden"].shape == (1, 3, 32)


def test_trainable_masks_match_jax():
    from summer_clip_tpu.engine.checkpoint import filter_tree as jfilter
    from summer_clip_tpu.models import gpt2 as jg
    from summer_clip_torch.engine.checkpoint import filter_tree

    _, jv, tm = make_pair("clip_gpt", "test-gpt")
    for tmask, jmask in ((tg.clip_gpt_trainable_mask, jg.clip_gpt_trainable_mask),
                         (tg.clip_gpt_full_trainable_mask, jg.clip_gpt_full_trainable_mask)):
        got = filter_tree(tm.tree(), tmask)
        want = jfilter(jv["params"], jmask)
        assert set(got) == set(want)
        assert set(got.get("core", {})) == set(want.get("core", {}))


def test_init_weights_is_seeded_and_scaled():
    cfg = tg.GPT2_CONFIGS["test-gpt-mega"]
    a = tg.ClipGPT(cfg, **CLIP_KW).init_weights(torch.Generator().manual_seed(3))
    b = tg.ClipGPT(cfg, **CLIP_KW).init_weights(torch.Generator().manual_seed(3))
    assert torch.equal(a.core.h_1.mlp_c_fc.kernel, b.core.h_1.mlp_c_fc.kernel)
    assert abs(float(a.core.h_0.attn.c_attn.kernel.std()) - 256 ** -0.5) < 0.01
    assert float(a.core.h_0.ln_1.scale.min()) == 1.0 and float(a.core.h_0.attn.c_attn.bias.abs().max()) == 0.0
    assert abs(float(a.clip_emb.std()) - 0.02) < 0.005 and abs(float(a.core.wpe.std()) - 0.01) < 0.002


def test_convert_hf_gpt2_matches_transformers():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.GPT2Config(vocab_size=512, n_positions=96, n_embd=32, n_layer=2, n_head=2,
                                     resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    hf = transformers.GPT2LMHeadModel(hf_cfg).eval()
    tm = tg.GPT2(tg.GPT2_CONFIGS["test-gpt"]).load_tree(tg.convert_hf_gpt2(hf.state_dict(), 2)).eval()
    ids = _t(_ids(8, (2, 9), 512))
    with torch.no_grad():
        want = hf(ids).logits.numpy()
        got = tm(ids)["logits"].numpy()
    np.testing.assert_allclose(got, want, **TOL)
