"""Tensor-parallel decode of the port against the JAX package on the CPU.

The slicing rules (``gpt2_tp_spec``, the int8 decode layout, the qkv
permutation) and each rank's slices are held bit for bit against the JAX
package's (its ``addressable_shards`` on the virtual mesh of
``tests/conftest.py``) in this process. Then one gloo group of 4 ranks
(``parallel.launch``, ``tests/torch_parallel_ranks.tp_rank``, started once for
the file) decodes every case at tp = 2 (a 2 x 2 mesh: two TP groups side by
side) and, where the heads divide, at tp = 4: the device loop, the batched
sampler with ``key_pad`` and eot, a sampled run and the engine, GPT2 and
ClipGPT, f32 and int8. Greedy ids must equal the port's solo run and the JAX
package's TP run (``tests/test_parallel.py``'s contract), and every rank must
return the same ids.
"""

import numpy as np
import pytest
import torch

from summer_clip_torch.models import gpt2 as tg
from summer_clip_torch.parallel import Mesh, gpt2_tp_spec, launch, permute_qkv_columns
from summer_clip_torch.parallel.tp_int8 import shard_decode_tp_int8, tp_int8_spec
from tests import torch_parallel_ranks as R

CLIP_KW = dict(clip_vocab_size=300, clip_emb_dim=16, emb_hid_dim=24, head_hid_dim=24)
PROMPT = [3, 14, 15, 2]
PROMPTS = [[3, 14, 15], [9, 2, 6, 5, 3], [11]]
ENGINE = [[5, 6, 7], [1, 2, 3, 4, 5]]
# (kind, config, int8): test-gpt as the JAX TP tests take it; test-gpt-mega
# (4 heads, width 256) for tp = 4 and tile-legal int8 slices
CASES = {"gpt2_f32": ("gpt2", "test-gpt", False), "clip_f32": ("clip_gpt", "test-gpt", False),
         "gpt2_int8": ("gpt2", "test-gpt", True), "clip_int8": ("clip_gpt", "test-gpt", True),
         "mega_clip_int8": ("clip_gpt", "test-gpt-mega", True)}


def _jax_params(kind, config, quant):
    import jax

    from summer_clip_tpu.engine.quant import quantize_tree
    from summer_clip_tpu.models import gpt2 as jg

    cfg = jg.GPT2_CONFIGS[config]
    jm = jg.GPT2(cfg) if kind == "gpt2" else jg.ClipGPT(cfg, **CLIP_KW)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), np.zeros((1, 4), np.int32))["params"]
    return jm, quantize_tree(params) if quant else params


def _numpy(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _port(kind, config, tree):
    cfg = tg.GPT2_CONFIGS[config]
    m = tg.GPT2(cfg, device="cpu") if kind == "gpt2" else tg.ClipGPT(cfg, device="cpu", **CLIP_KW)
    return m.load_tree(tg.from_flax_variables(tree)).eval()


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) and set(v) != {"q", "scale"}:
            yield from _paths(v, prefix + (str(k),))
        elif isinstance(v, dict):
            yield prefix + (str(k), "q"), v["q"]
            yield prefix + (str(k), "scale"), v["scale"]
        else:
            yield prefix + (str(k),), v


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_specs_equal_the_jax_packages_leaf_by_leaf(quant):
    from jax.tree_util import DictKey

    from summer_clip_tpu.parallel import gpt2_tp_spec as jspec
    from summer_clip_tpu.parallel.tp_int8 import _tp_int8_spec as jspec8

    _, params = _jax_params("clip_gpt", "test-gpt", quant)
    n = 0
    for path, leaf in _paths(_numpy(params)):
        jpath = tuple(DictKey(p) for p in path)
        assert gpt2_tp_spec(path, leaf) == tuple(jspec(jpath, leaf)), path
        assert tp_int8_spec(path, leaf) == tuple(jspec8(jpath, leaf)), path
        n += 1
    assert n > 20


def test_qkv_permutation_equals_the_jax_packages():
    from summer_clip_tpu.parallel import permute_qkv_columns as jperm

    rng = np.random.RandomState(0)
    w = rng.randn(32, 96).astype(np.float32)
    b = rng.randn(96).astype(np.float32)
    q = rng.randint(-127, 128, (32, 96)).astype(np.int8)
    s = rng.rand(1, 96).astype(np.float32)
    for tp_size in (1, 2, 4):
        np.testing.assert_array_equal(permute_qkv_columns(torch.from_numpy(w), 32, tp_size).numpy(),
                                      np.asarray(jperm(w, 32, tp_size)))
        np.testing.assert_array_equal(permute_qkv_columns(torch.from_numpy(b), 32, tp_size).numpy(),
                                      np.asarray(jperm(b, 32, tp_size)))
        got = permute_qkv_columns(tg.QLeaf(torch.from_numpy(q), torch.from_numpy(s)), 32, tp_size)
        want = jperm({"q": q, "scale": s}, 32, tp_size)
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want["q"]))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want["scale"]))


def _fake_mesh(rank, model):
    return Mesh({"data": 1, "model": model}, {"data": 0, "model": rank}, rank,
                torch.device("cpu"), {"data": None, "model": None})


@pytest.mark.parametrize("tp_size", [2, 4])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_rank_slices_are_the_jax_shards(devices8, quant, tp_size):
    """Each rank's decode tree against the JAX ``shard_decode_tp_int8``'s
    ``addressable_shards`` on a 1 x tp mesh, leaf for leaf, bit for bit."""
    from summer_clip_tpu.parallel import create_mesh
    from summer_clip_tpu.parallel.tp_int8 import shard_decode_tp_int8 as jshard

    jm, params = _jax_params("clip_gpt", "test-gpt-mega", quant)
    cache = jm.apply({"params": params}, method=jm.init_cache, batch=1, max_len=4)
    jvars, _ = jshard({"params": params}, cache,
                      create_mesh(data=1, model=tp_size, devices=devices8[:tp_size]))
    model = _port("clip_gpt", "test-gpt-mega", _numpy(params))
    jleaves = dict(_paths(jvars["params"]))
    for r in range(tp_size):
        local = shard_decode_tp_int8(model.tree(), _fake_mesh(r, tp_size))
        n = 0
        for path, leaf in _paths(_torch_tree_as_dicts(local)):
            jleaf = jleaves[path]
            shard = next(s for s in jleaf.addressable_shards if s.device == devices8[r])
            np.testing.assert_array_equal(leaf, np.asarray(shard.data), err_msg=str((path, r)))
            n += 1
        assert n > 20


def _torch_tree_as_dicts(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _torch_tree_as_dicts(v)
        elif tg.is_qleaf(v):
            out[k] = {"q": v.q.numpy(), "scale": v.scale.numpy()}
        else:
            out[k] = v.detach().numpy()
    return out


def test_simulated_ranks_row_and_column_products_sum_to_the_whole():
    """The per-rank math in one process: column slices (permuted qkv) of c_attn
    concatenated are the permuted whole product; row slices of c_proj summed
    are the whole product."""
    model = _port("gpt2", "test-gpt-mega", _numpy(_jax_params("gpt2", "test-gpt-mega", False)[1]))
    tree = model.tree()["core"]["h_0"]
    x = torch.from_numpy(np.random.RandomState(1).randn(3, 256).astype(np.float32))
    from summer_clip_torch.parallel.tp_int8 import _qkv_perm

    cols, rows = [], []
    for r in range(4):
        local = shard_decode_tp_int8(model.tree(), _fake_mesh(r, 4))["core"]["h_0"]
        cols.append(x @ local["attn"]["c_attn"]["kernel"])
        rows.append(x[:, r * 64:(r + 1) * 64] @ local["attn"]["c_proj"]["kernel"])
    whole = (x @ tree["attn"]["c_attn"]["kernel"])[:, torch.from_numpy(_qkv_perm(256, 4))]
    torch.testing.assert_close(torch.cat(cols, 1), whole, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(sum(rows), x @ tree["attn"]["c_proj"]["kernel"], atol=1e-4,
                               rtol=1e-5)


@pytest.fixture(scope="module")
def tp_runs():
    cases = {}
    for name, (kind, config, quant) in CASES.items():
        _, params = _jax_params(kind, config, quant)
        cases[name] = {"kind": kind, "config": config, "quant": quant, "tree": _numpy(params),
                       "prompt": PROMPT, "prompts": PROMPTS,
                       "engine": ENGINE if quant else None}
    results = launch(R.tp_rank, ["cpu"] * 4, cases)
    return cases, [r.value for r in results]


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp_decode_gives_the_solo_ids_on_every_rank(tp_runs, name):
    cases, values = tp_runs
    case = cases[name]
    solo = R.decode_cases(_port(case["kind"], case["config"], case["tree"]), case, None)
    sizes = [2, 4] if case["config"] == "test-gpt-mega" else [2]
    for tp_size in sizes:
        for r, v in enumerate(values):
            got = v[name, tp_size]
            assert got == values[0][name, tp_size], (r, tp_size)     # the ranks agree
            for k in ("device", "batched", "engine"):
                assert got.get(k) == solo.get(k), (k, tp_size)
        assert set(values[0]) >= {(name, t) for t in sizes}
    # the sampled run: the ranks draw alike; not held to solo (the sums differ)
    assert len({str(v[name, 2]["sampled"]) for v in values}) == 1


@pytest.mark.parametrize("name", ["gpt2_f32", "clip_f32", "gpt2_int8", "clip_int8"])
def test_tp_decode_gives_the_jax_tp_ids(tp_runs, devices8, name):
    """The JAX package's TP decode at tp = 2 on its virtual mesh (GSPMD for
    the f32 tree, its shard_map decoder for int8): the same greedy ids."""
    import jax

    from summer_clip_tpu.apps import gen_gpt as jgen
    from summer_clip_tpu.parallel import create_mesh

    cases, values = tp_runs
    kind, config, quant = CASES[name]
    jm, params = _jax_params(kind, config, quant)
    mesh = create_mesh(data=1, model=2, devices=devices8[:2])
    variables = {"params": params}
    got = values[0][name, 2]
    if name in ("gpt2_f32", "gpt2_int8", "clip_int8"):
        want = jgen.generate_device(jm, variables, PROMPT, max_new_tokens=10, top_k=1,
                                    quant_int8=quant, rng=jax.random.PRNGKey(5), mesh=mesh)
        assert got["device"] == want
    if name in ("clip_f32", "gpt2_int8"):
        want = jgen.generate_device_batched(jm, variables, PROMPTS, max_new_tokens=8, top_k=1,
                                            quant_int8=quant, rng=jax.random.PRNGKey(7), eot_id=7,
                                            mesh=mesh)
        assert got["batched"] == want
    if name == "gpt2_int8":
        from summer_clip_tpu.engine.serving import ContinuousBatcher

        eng = ContinuousBatcher(jm, variables, batch_slots=2, max_len=48, greedy=True,
                                quant_int8=True, mesh=mesh, burst=4, pipeline=2)
        reqs = [eng.submit(p, max_new_tokens=6) for p in ENGINE]
        eng.run()
        assert got["engine"] == [r.out_ids for r in reqs]


def test_tp_int8_decoder_is_kept_by_its_caller():
    """``tp_int8_decoder`` keeps no decoder alive: each call on a model cuts
    new slices, a decoder passes through, and a dropped decoder and its
    model are freed."""
    import gc
    import weakref

    from summer_clip_torch.parallel import TPInt8Decoder, tp_int8_decoder

    model = _port("gpt2", "test-gpt", _numpy(_jax_params("gpt2", "test-gpt", True)[1]))
    mesh = _fake_mesh(0, 2)
    dec = tp_int8_decoder(model, mesh)
    assert isinstance(dec, TPInt8Decoder) and tp_int8_decoder(dec, mesh) is dec
    assert tp_int8_decoder(model, mesh) is not dec
    gone = weakref.ref(model), weakref.ref(dec)
    del model, dec
    gc.collect()
    assert [r() for r in gone] == [None, None]


def test_tp_refuses_the_megakernel_and_bad_head_counts():
    from summer_clip_torch.apps import gen_gpt
    from summer_clip_torch.parallel import check_tp_divisibility

    model = _port("gpt2", "test-gpt", _numpy(_jax_params("gpt2", "test-gpt", False)[1]))
    mesh = Mesh({"data": 1, "model": 2}, {"data": 0, "model": 0}, 0, torch.device("cpu"),
                {"data": None, "model": object()})
    with pytest.raises(ValueError, match="megakernel"):
        gen_gpt.generate_device(model, PROMPT, max_new_tokens=2, megakernel=True, mesh=mesh)
    with pytest.raises(ValueError):
        check_tp_divisibility(32, 2, 4)
    check_tp_divisibility(1280, 20, 2)
