"""``summer_clip_torch.ops.decode_block`` against ``summer_clip_tpu.ops.decode_block``.

The same numbers (numpy, from a seed) go through both packages at the JAX
tests' size (``mega-test``: D = 128, 2 blocks, 2 heads). Packing, the row
quantiser, the ring conversion and the ring update are held exact (against the
jitted JAX functions: that is how the JAX samplers run them). The plain version
is held against the JAX oracle and against the Pallas kernel in interpret mode
at ``1e-4 * max|y|``: the three share every rounding point and differ in the
order of f32 sums only. On the CPU ``decode_block`` is its plain version; the
``cuda`` case runs K8 on the card.
"""

import numpy as np
import pytest
import torch

from summer_clip_torch.models import gpt2 as tg
from summer_clip_torch.ops import decode_block as DB

D, LAYERS, HEADS, T = 128, 2, 2, 256
TOL_REL = 1e-4     # of max|y|: f32 sums in another order, rounding points shared


def _np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def pair():
    """JAX params of ``mega-test`` (plain and int8), and the port's tree of each."""
    import jax
    import jax.numpy as jnp

    from summer_clip_tpu.engine.quant import quantize_tree as jquantize
    from summer_clip_tpu.models import gpt2 as jg

    cfg = jg.GPT2Config("mega-test", vocab_size=512, n_positions=256, n_embd=D, n_layer=LAYERS,
                        n_head=HEADS)
    model = jg.GPT2(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    # biases and LayerNorm leaves that are not their initial zeros and ones
    rng = np.random.RandomState(5)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.1 * jnp.asarray(rng.randn(*x.shape), x.dtype)
        if path[-1].key in ("bias", "scale") else x, params)
    qparams = jquantize(params)
    return {"jax": params, "jax_q": qparams, "torch": tg.from_flax_variables(_np(params)),
            "torch_q": tg.from_flax_variables(_np(qparams))}


def _rings(rng, kv_np_dtype, batch, filled):
    """JAX rings with ``filled`` plausible rows a stream, and the port's copy."""
    import jax.numpy as jnp

    from summer_clip_tpu.ops import decode_block as JDB

    kv = JDB.init_mega_kv(LAYERS, D, T, kv_np_dtype, batch=batch)
    shape = (LAYERS, filled, D) if batch is None else (LAYERS, batch, filled, D)
    pre = jnp.asarray(rng.randn(*shape), jnp.float32)
    kq, ks = JDB._quant_rows(pre, kv_np_dtype)
    vq, vs = JDB._quant_rows(pre[..., ::-1, :] * 0.5, kv_np_dtype)
    sl = (slice(None),) * (1 if batch is None else 2) + (slice(0, filled),)
    kv = {"k": kv["k"].at[sl].set(kq), "v": kv["v"].at[sl].set(vq),
          "ks": kv["ks"].at[sl].set(ks), "vs": kv["vs"].at[sl].set(vs)}
    return kv, DB.mega_from_numpy(_np(kv))


def _assert_same(got, want):
    want = np.asarray(want)
    if want.dtype.name == "bfloat16":
        got, want = got.to(torch.float32).numpy(), want.astype(np.float32)
    else:
        got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tree,store", [("torch", "int8"), ("torch", "bf16"), ("torch_q", "int8"),
                                        ("torch_q", "bf16")])
def test_pack_core_params_is_the_jax_packages_bit_for_bit(pair, tree, store):
    import jax

    from summer_clip_tpu.ops import decode_block as JDB

    want = jax.jit(lambda c: JDB.pack_core_params(c, LAYERS, store=store))(
        pair[tree.replace("torch", "jax")]["core"])
    got = DB.pack_core_params(pair[tree]["core"], LAYERS, store=store)
    assert set(got) == set(want)
    for key in want:
        _assert_same(got[key], want[key])
    # the typed copy of the JAX package's slabs is the port's own packing
    carried = DB.mega_from_numpy(_np(want))
    for key in want:
        assert carried[key].dtype == got[key].dtype and torch.equal(carried[key], got[key]), key


@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_quant_rows_and_cache_to_mega_are_exact(kv):
    import jax
    import jax.numpy as jnp

    from summer_clip_tpu.ops import decode_block as JDB

    jdt, tdt = (jnp.int8, torch.int8) if kv == "int8" else (jnp.bfloat16, torch.bfloat16)
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 5, D) * np.exp(rng.randn(3, 5, 1))).astype(np.float32)
    x[0, 0] = 0.0    # an all-zero row: the scale's floor
    for got, want in zip(DB._quant_rows(torch.from_numpy(x), tdt),
                         jax.jit(lambda a: JDB._quant_rows(a, jdt))(x)):
        _assert_same(got, want)
    cache = [{"k": rng.randn(2, 9, D).astype(np.float32), "v": rng.randn(2, 9, D).astype(np.float32),
              "index": 9} for _ in range(LAYERS)]
    tcache = [{k: torch.from_numpy(v) if k != "index" else v for k, v in c.items()} for c in cache]
    for batched in (False, True):
        want = jax.jit(lambda c: JDB.cache_to_mega(c, 40, jdt, batched=batched))(
            [{k: v for k, v in c.items() if k != "index"} for c in cache])
        got = DB.cache_to_mega(tcache, 40, tdt, batched=batched)
        assert got["k"].shape[-2] == T      # padded to the store format's 256
        for key in want:
            _assert_same(got[key], want[key])


def test_mega_update_kv_writes_in_place_and_clamps():
    import jax.numpy as jnp

    from summer_clip_tpu.ops import decode_block as JDB

    rng = np.random.RandomState(2)
    for batch, index in ((None, 7), (None, T + 3), (3, [0, 255, 300])):
        kv, tkv = _rings(rng, jnp.int8, batch, 4)
        b = 1 if batch is None else batch
        kq = rng.randint(-127, 128, (LAYERS, b, D)).astype(np.int8)
        vq = rng.randint(-127, 128, (LAYERS, b, D)).astype(np.int8)
        ksn = rng.rand(LAYERS, b, 1).astype(np.float32)
        vsn = rng.rand(LAYERS, b, 1).astype(np.float32)
        want = JDB.mega_update_kv(kv, kq, vq, ksn, vsn, jnp.asarray(index, jnp.int32))
        got = DB.mega_update_kv(tkv, *(torch.from_numpy(a) for a in (kq, vq, ksn, vsn)),
                                torch.tensor(index))
        assert got is tkv                    # the rings themselves, written in place
        for key in want:
            _assert_same(got[key], want[key])


CASES = {
    # name: (batch or None for the legacy layout, index, pad)
    "single": (None, 7, None),
    "single_index_0": (None, 0, None),
    "batched_pad": (3, [7, 0, 9], [0, 0, 2]),
    "batched_full_ring": (2, [T, 5], [250, 0]),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("store,kv", [("int8", "int8"), ("bf16", "bf16")])
def test_plain_version_agrees_with_the_jax_oracle_and_the_interpreted_kernel(pair, store, kv, case):
    import jax.numpy as jnp

    from summer_clip_tpu.ops import decode_block as JDB

    batch, index, pad = CASES[case]
    jdt = jnp.int8 if kv == "int8" else jnp.bfloat16
    rng = np.random.RandomState(3)
    packed = JDB.pack_core_params(pair["jax"]["core"], LAYERS, store=store)
    filled = 9 if case != "batched_full_ring" else T
    jkv, tkv = _rings(rng, jdt, batch, filled)
    x = rng.randn(1 if batch is None else batch, D).astype(np.float32)
    jpad = None if pad is None else jnp.asarray(pad, jnp.int32)
    oracle = JDB.decode_block_reference(jnp.asarray(x), packed, jkv, jnp.asarray(index, jnp.int32),
                                        nh=HEADS, pad=jpad)
    kernel = JDB.decode_block(jnp.asarray(x), packed, jkv, jnp.asarray(index, jnp.int32),
                              nh=HEADS, pad=jpad, interpret=True)
    before = DB.decode_block.launches
    got = DB.decode_block(torch.from_numpy(x), DB.mega_from_numpy(_np(packed)), tkv,
                          torch.tensor(index), nh=HEADS,
                          pad=None if pad is None else torch.tensor(pad))
    assert DB.decode_block.launches == before     # the CPU route is the plain version
    for name, want in (("oracle", oracle), ("interpreted kernel", kernel)):
        y = np.asarray(want[0])
        assert got[0].shape == y.shape
        assert np.abs(got[0].numpy() - y).max() <= TOL_REL * np.abs(y).max(), name
        for g, w in zip(got[1:3], want[1:3]):     # fresh rows: one int8 step at a rounding tie
            assert g.shape == w.shape
            assert np.abs(g.to(torch.float32).numpy()
                          - np.asarray(w).astype(np.float32)).max() <= 1.0, name
        for g, w in zip(got[3:], want[3:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, err_msg=name)


def test_streams_are_independent_in_the_plain_version(pair):
    """A stream's row of a batched call is its solo call, bit for bit."""
    import jax.numpy as jnp

    rng = np.random.RandomState(4)
    packed = DB.pack_core_params(pair["torch_q"]["core"], LAYERS, store="int8")
    _, tkv = _rings(rng, jnp.int8, 3, 9)
    x = torch.from_numpy(rng.randn(3, D).astype(np.float32))
    index, pad = torch.tensor([7, 0, 9]), torch.tensor([0, 0, 2])
    full = DB.decode_block(x, packed, tkv, index, nh=HEADS, pad=pad)
    for b in range(3):
        solo = DB.decode_block(x[b:b + 1], packed, {k: v[:, b:b + 1] for k, v in tkv.items()},
                               index[b:b + 1], nh=HEADS, pad=pad[b:b + 1])
        assert torch.equal(full[0][b:b + 1], solo[0])
        for f, s in zip(full[1:], solo[1:]):
            assert torch.equal(f[:, b:b + 1], s)


@pytest.mark.parametrize("d,h,nh", [(1280, 5120, 20), (768, 3072, 12), (1024, 4096, 16),
                                    (1600, 6400, 25), (256, 1024, 4), (32, 128, 2)])
def test_mega_legal_is_the_jax_packages_rule(d, h, nh):
    from summer_clip_tpu.ops import decode_block as JDB

    assert DB.mega_legal(d, h, nh) == JDB.mega_legal(d, h, nh)


GPT2_WIDTHS = {"gpt2": (768, 3072), "gpt2-medium": (1024, 4096), "gpt2-large": (1280, 5120)}


def test_stage_chunks_depend_on_the_geometry_only():
    """K8's work split of a product: column tiles of 16 to 256 bytes, the K
    axis split over a cluster's 4 CTAs in TMA boxes that divide the chunk, hold
    at most 16 KB and fit the ring 8 at a time; a function of (K, N, item size)
    alone. At gpt2-large a cluster of 32 takes one tile of each product."""
    import inspect

    assert list(inspect.signature(DB.stage_plan).parameters) == ["k", "n", "itemsize"]
    for d, h in GPT2_WIDTHS.values():
        for _, k, n in DB._products(d, h):
            for size in (1, 2):
                twb, br = DB.stage_plan(k, n, size)
                kc = k // DB.CLUSTER
                assert twb in (16, 32, 64, 128, 256) and k % DB.CLUSTER == 0
                assert kc % br == 0 and br % 8 == 0 and br <= 256 and twb * br <= 16384
                assert kc // br <= 8          # a tile's boxes fit the ring
    tiles = {name: -(-n // DB.stage_plan(k, n, 1)[0]) for name, k, n in DB._products(1280, 5120)}
    assert tiles == {"qkv": 30, "proj": 20, "fc": 20, "out": 20}
    assert DB.barriers(36) == 179


def _cursor_walk(n_layer, d, h, size, clusters, cl, rank):
    """The kernel's Cursor (settle, step) in Python: the order in which a CTA's
    ring asks TMA for its boxes, one box after another across the launch."""
    prods = DB._products(d, h)
    plans = [DB.stage_plan(k, n, size) for _, k, n in prods]
    tiles = [-(-n * size // twb) for (_, _, n), (twb, _) in zip(prods, plans)]
    prefix = [sum(tiles[:p]) for p in range(4)]

    def first(lay, p):
        return (cl - (lay * sum(tiles) + prefix[p]) % clusters + clusters) % clusters

    lay, p, t, j = 0, 0, first(0, 0), 0
    out = []
    while True:
        while lay < n_layer and t >= tiles[p]:        # settle
            p += 1
            if p == 4:
                p, lay = 0, lay + 1
            j = 0
            if lay < n_layer:
                t = first(lay, p)
        if lay >= n_layer:
            return out
        k = prods[p][1]
        twb, br = plans[p]
        out.append((lay, p, t * twb, rank * (k // DB.CLUSTER) + j * br, twb, br))
        j += 1                                          # step
        if j * br == k // DB.CLUSTER:
            j, t = 0, t + clusters


@pytest.mark.parametrize("model", sorted(GPT2_WIDTHS))
@pytest.mark.parametrize("store", ["int8", "bf16"])
def test_weight_boxes_cover_every_weight_once_in_the_consumers_order(model, store):
    """Over all CTAs of a grid (32 or 33 clusters of 4), the boxes the ring
    asks for cover every row and every byte of every product's matrix exactly
    once, and each CTA asks for its boxes in the order its stages consume
    them (the device cursor's walk equals the stages' nested loops)."""
    d, h = GPT2_WIDTHS[model]
    size = 1 if store == "int8" else 2
    n_layer = 3
    for clusters in (32, 33):
        cover = {(lay, p): np.zeros((k, -(-n * size // 16)), np.int32)
                 for lay in range(n_layer) for p, (_, k, n) in enumerate(DB._products(d, h))}
        for cl in range(clusters):
            for rank in range(DB.CLUSTER):
                boxes = DB.weight_boxes(n_layer, d, h, size, clusters, cl, rank)
                assert boxes == _cursor_walk(n_layer, d, h, size, clusters, cl, rank)
                assert boxes == sorted(boxes, key=lambda b: (b[0], b[1]))   # stage by stage
                for lay, p, col, row, twb, br in boxes:
                    kc = DB._products(d, h)[p][1] // DB.CLUSTER
                    assert rank * kc <= row and row + br <= (rank + 1) * kc   # the rank's chunk
                    cover[lay, p][row:row + br, col // 16:(col + twb) // 16] += 1
        for (lay, p), c in cover.items():
            n = DB._products(d, h)[p][2]
            assert (c[:, :n * size // 16] == 1).all(), (clusters, lay, p)


@pytest.mark.cuda
@pytest.mark.parametrize("store,kv", [("int8", torch.int8), ("bf16", torch.bfloat16)])
def test_cuda_kernel_agrees_with_the_plain_version(store, kv):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(0)
    model = tg.GPT2(tg.GPT2_CONFIGS["test-gpt-mega"], device="cuda").init_weights(gen)
    cfg = model.config
    packed = DB.pack_core_params(model.tree()["core"], cfg.n_layer, store=store)
    rows = torch.randn((cfg.n_layer, 3, 512, cfg.n_embd), generator=gen).cuda()
    k, ks = DB._quant_rows(rows, kv)
    v, vs = DB._quant_rows(rows.flip(2) * 0.5, kv)
    rings = {"k": k, "v": v, "ks": ks, "vs": vs}
    x = torch.randn((3, cfg.n_embd), generator=gen).cuda()
    index = torch.tensor([300, 0, 512], device="cuda")
    pad = torch.tensor([17, 0, 260], device="cuda")
    before = DB.decode_block.launches
    got = DB.decode_block(x, packed, rings, index, nh=cfg.n_head, pad=pad)
    torch.cuda.synchronize()
    assert DB.decode_block.launches == before + 1
    want = DB.decode_block_reference(x, packed, rings, index, nh=cfg.n_head, pad=pad)
    assert float((got[0] - want[0]).abs().max()) <= 1e-3 * float(want[0].abs().max())
    for g, w in zip(got[1:3], want[1:3]):
        assert float((g.float() - w.float()).abs().max()) <= 1.0
    again = DB.decode_block(x, packed, rings, index, nh=cfg.n_head, pad=pad)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    solo = DB.decode_block(x[:1], packed, {n: t[:, :1].contiguous() for n, t in rings.items()},
                           index[:1], nh=cfg.n_head, pad=pad[:1])
    assert torch.equal(solo[0], got[0][:1])
    grid = DB.grid_blocks(packed["wqkv"].dtype, kv, 3)     # whole clusters, one CTA an SM
    assert grid % DB.CLUSTER == 0
    assert 0 < grid <= torch.cuda.get_device_properties(0).multi_processor_count
