"""``summer_clip_torch.engine.quant`` against ``summer_clip_tpu.engine.quant``.

The same f32 numbers (a JAX-initialised tree carried across as numpy) go
through both packages' ``quantize_tree``. The arithmetic is the same operation
for operation (abs-max, times 1/127, divide, round half to even, clip), so
``q`` and ``scale`` are equal bit for bit. ``quant_head_table`` first runs the
head adapter (two f32 products whose sums the two frameworks order
differently), so its scales agree to 1e-6 relative and an entry of ``q`` may
differ by one step where the quotient lies within that of a half.
"""

import numpy as np
import pytest
import torch

from summer_clip_torch.engine import quant as tq
from summer_clip_torch.models import gpt2 as tg
from summer_clip_torch.ops.gemv import QLeaf, is_qleaf

CLIP_KW = dict(clip_vocab_size=300, clip_emb_dim=16, emb_hid_dim=24, head_hid_dim=24)


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jax_model(kind, config, seed=0):
    import jax

    from summer_clip_tpu.models import gpt2 as jg

    cfg = jg.GPT2_CONFIGS[config]
    jm = jg.GPT2(cfg) if kind == "gpt2" else jg.ClipGPT(cfg, **CLIP_KW)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), np.zeros((1, 4), np.int32))["params"]
    return jm, params


def _port_model(kind, config, tree):
    cfg = tg.GPT2_CONFIGS[config]
    tm = tg.GPT2(cfg) if kind == "gpt2" else tg.ClipGPT(cfg, **CLIP_KW)
    return tm.load_tree(tree).eval()


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


@pytest.mark.parametrize("kind", ["gpt2", "clip_gpt"])
def test_quantize_tree_is_bit_identical_to_the_jax_packages(kind):
    from summer_clip_tpu.engine.quant import quantize_tree as jquantize

    _, params = _jax_model(kind, "test-gpt-mega")
    want = dict(_flat(tg.from_flax_variables(_np_tree(jquantize(params)))))
    got = dict(_flat(tq.quantize_tree(tg.from_flax_variables(_np_tree(params)))))
    assert set(got) == set(want)
    n_q = 0
    for path, leaf in got.items():
        if is_qleaf(want[path]):
            n_q += 1
            assert is_qleaf(leaf), path
            assert leaf.q.dtype == torch.int8 and leaf.scale.dtype == torch.float32
            assert tuple(leaf.scale.shape) == tuple(want[path].scale.shape), path
            assert torch.equal(leaf.scale, want[path].scale), path
            assert torch.equal(leaf.q, want[path].q), path
        else:
            assert not is_qleaf(leaf) and torch.equal(leaf, want[path]), path
    assert n_q >= 2 * 4 + 2


def test_quantize_tree_scales_per_column_and_per_row_and_keeps_small_leaves():
    _, params = _jax_model("clip_gpt", "test-gpt")
    tree = tq.quantize_tree(tg.from_flax_variables(_np_tree(params)))
    kernel = tree["core"]["h_0"]["attn"]["c_attn"]["kernel"]
    assert tuple(kernel.q.shape) == (32, 96) and tuple(kernel.scale.shape) == (1, 96)
    for table in (tree["clip_emb"], tree["core"]["wpe"]):
        assert tuple(table.scale.shape) == (table.q.shape[0], 1)
    for small in (tree["core"]["h_0"]["ln_1"]["scale"], tree["core"]["h_0"]["attn"]["c_attn"]["bias"],
                  tree["core"]["ln_f"]["bias"]):
        assert isinstance(small, torch.Tensor) and small.dtype == torch.float32
    assert int(kernel.q.abs().max()) == 127


def test_quantize_array_edge_cases_equal_jax():
    """Against the jitted JAX function, which is how ``quantize_tree`` and the
    ClipGPT head table run it (there the division by 127 is a product with the
    f32 reciprocal; run eagerly it is a division, an ulp apart now and then)."""
    import functools

    import jax
    import jax.numpy as jnp

    from summer_clip_tpu.engine.quant import quantize_array as jquantize_array

    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 10)).astype(np.float32)
    x[:, 3] = 0.0                                   # an all-zero column: the 1e-12 floor
    x[2, 5] = 0.5 * np.abs(x[:, 5]).max() / 127.0 * 3   # lands on a half: round to even
    for per_row in (False, True):
        want = jax.jit(functools.partial(jquantize_array, per_row=per_row))(jnp.asarray(x))
        got = tq.quantize_array(torch.from_numpy(x), per_row=per_row)
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want["q"]))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want["scale"]))


def test_dequantize_and_cast_match_jax():
    import jax.numpy as jnp

    from summer_clip_tpu.engine import quant as jq

    _, params = _jax_model("gpt2", "test-gpt")
    tree = tg.from_flax_variables(_np_tree(params))
    deq = tq.dequantize_tree(tq.quantize_tree(tree), torch.float32)
    want = _np_tree(jq.dequantize_tree(jq.quantize_tree(params), jnp.float32))
    for path, leaf in _flat(deq):
        node = want
        for k in path:
            node = node[k]
        np.testing.assert_allclose(leaf.numpy(), node, rtol=1e-6, atol=0)
    # one step of the grid at most away from the original
    kernel, back = tree["core"]["h_0"]["mlp_c_fc"]["kernel"], deq["core"]["h_0"]["mlp_c_fc"]["kernel"]
    assert float((kernel - back).abs().max()) <= float(kernel.abs().max()) / 127.0
    cast = tq.cast_params(tree)
    assert cast["wte"]["embedding"].dtype == torch.bfloat16
    assert cast["core"]["h_0"]["attn"]["c_attn"]["kernel"].dtype == torch.bfloat16
    assert cast["core"]["h_0"]["attn"]["c_attn"]["bias"].dtype == torch.float32
    assert cast["core"]["h_0"]["ln_1"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("kind,quant", [("gpt2", False), ("gpt2", True), ("clip_gpt", False),
                                        ("clip_gpt", True)])
def test_quant_head_table_matches_jax(kind, quant):
    from summer_clip_tpu.engine import quant as jq

    jm, params = _jax_model(kind, "test-gpt-mega")
    if quant:
        params = jq.quantize_tree(params)
    want = _np_tree(jq.quant_head_table(jm, {"params": params}))
    tm = _port_model(kind, "test-gpt-mega", tg.from_flax_variables(_np_tree(params)))
    got = tq.quant_head_table(tm)
    vocab = 512 if kind == "gpt2" else 300
    assert isinstance(got, QLeaf) and tuple(got.q.shape) == (256, vocab)
    assert tuple(got.scale.shape) == tuple(want["scale"].shape)
    assert got.q.is_contiguous()                     # K7 reads it row-major as stored
    np.testing.assert_allclose(got.scale.numpy(), want["scale"], rtol=1e-6, atol=0)
    if kind == "gpt2":                               # no adapter in the way: bit for bit
        np.testing.assert_array_equal(got.q.numpy(), want["q"])
    else:
        step = np.abs(got.q.numpy().astype(np.int32) - want["q"].astype(np.int32))
        assert step.max() <= 1 and (step > 0).mean() < 1e-3
    np.testing.assert_allclose(got.dequantize().numpy(), want["q"].astype(np.float32) * want["scale"],
                               rtol=0, atol=1.01 * float(want["scale"].max()))
