"""K7 / K10 (weight-streaming products) and their routing, against the JAX package.

The JAX side runs ``streamed_qmatmul`` / ``fused_qmlp`` in Pallas interpret
mode and their ``*_reference``; the port runs its wrappers on CPU tensors, i.e.
the plain versions. Same numpy inputs. Every product of a bf16 and an int8 or
bf16 value is exact in f32, so the two sides differ by the order of their f32
sums only: rtol 1e-5 of the largest output. K10's hidden is rounded to bf16
before the second product; a hidden that differs in its last f32 bit may round
to the neighbouring bf16 value (2^-8 relative, one term of H), hence 1e-4
there. K10's plan is walked in numpy and held against the plain version. The
``cuda`` tests compare the CUDA kernels with the plain versions on a card and
skip without one.
"""

import numpy as np
import pytest
import torch

from summer_clip_torch.ops import gemv


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()))


def _quant(rng, k, n):
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    scale = (np.abs(w).max(0, keepdims=True) / 127.0).astype(np.float32)
    return np.clip(np.round(w / scale), -127, 127).astype(np.int8), scale


def _weights(rng, k, n, wtype):
    if wtype == "int8":
        return _quant(rng, k, n)
    return (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32), None


def _jnp_weight(w, wtype):
    import jax.numpy as jnp

    return jnp.asarray(w, jnp.bfloat16) if wtype == "bf16" else jnp.asarray(w)


def _torch_weight(w, wtype):
    t = torch.from_numpy(w)
    return t.to(torch.bfloat16) if wtype == "bf16" else t


@pytest.mark.parametrize("wtype", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("rows,k,n", [(1, 256, 768), (8, 256, 256), (3, 1024, 512), (5, 64, 200)])
def test_k7_plain_version_matches_jax_kernel_and_reference(rows, k, n, wtype):
    import jax.numpy as jnp

    from summer_clip_tpu.ops import gemv as jgemv

    rng = np.random.default_rng(rows * 1000 + k + n)
    x = rng.standard_normal((rows, k)).astype(np.float32)
    w, scale = _weights(rng, k, n, wtype)
    js = None if scale is None else jnp.asarray(scale)
    ts = None if scale is None else torch.from_numpy(scale)
    want_kernel = jgemv.streamed_qmatmul(jnp.asarray(x), _jnp_weight(w, wtype), js, interpret=True)
    want_ref = jgemv.matmul_reference(jnp.asarray(x), _jnp_weight(w, wtype), js)
    for fn in (gemv.matmul_reference, gemv.streamed_qmatmul):    # the CPU wrapper is the plain version
        got = fn(torch.from_numpy(x), _torch_weight(w, wtype), ts)
        assert got.dtype == torch.float32
        _close(got.numpy(), want_kernel, 1e-5)
        _close(got.numpy(), want_ref, 1e-5)
    assert gemv.streamed_qmatmul.launches == 0


def test_k7_plain_version_row_does_not_depend_on_its_companions():
    """What the JAX package pins for its kernel (a row's result is the same
    alone or among 8) holds for the plain version, bit for bit."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((8, 256)).astype(np.float32))
    w, scale = _quant(rng, 256, 384)
    w, scale = torch.from_numpy(w), torch.from_numpy(scale)
    full = gemv.matmul_reference(x, w, scale)
    for r in (0, 3, 7):
        _close(gemv.matmul_reference(x[r:r + 1], w, scale).numpy(), full[r:r + 1].numpy(), 1e-6)
    # 1-D scale and (1, N) scale are the same thing
    assert torch.equal(gemv.matmul_reference(x, w, scale.reshape(-1)), full)


@pytest.mark.parametrize("k,n,itemsize", [(256, 768, 1), (32, 128, 1), (48, 128, 1), (256, 96, 1),
                                          (16, 128, 2), (8, 128, 4), (1280, 49408, 1),
                                          (1280, 49408, 4), (32, 32, 4), (65536, 4096, 4)])
def test_tile_legal_and_block_rule_equal_the_jax_packages(k, n, itemsize):
    from summer_clip_tpu.ops import gemv as jgemv

    assert gemv._tile_legal(k, n, itemsize) == jgemv._tile_legal(k, n, itemsize)
    assert gemv._pick_bn(n, k, itemsize) == jgemv._pick_bn(n, k, itemsize)
    assert gemv.MAX_ROWS == jgemv._ROWS


GPT2_LARGE = {"c_attn": (1280, 3840), "c_proj": (1280, 1280), "mlp_c_fc": (1280, 5120),
              "mlp_c_proj": (5120, 1280), "lm_head": (1280, 49408), "adapter_fc1": (512, 1024),
              "adapter_fc2": (1024, 1280)}


@pytest.mark.parametrize("k,n", sorted(GPT2_LARGE.values()) + [(256, 768), (64, 200), (96, 130),
                                                              (5, 16), (65536, 128)])
@pytest.mark.parametrize("itemsize", [1, 2, 4])
def test_k7_plan_covers_the_matrix_once_from_its_geometry_alone(k, n, itemsize):
    """K7's plan is a function of (K, N, item size), never of the rows of x, and
    its CTAs' boxes cover every row and byte of w exactly once: a column tile's
    K chunks are disjoint, the last one may reach past K (TMA reads zeros
    there) but none starts past it. At gpt2-large every matrix but the first
    adapter gets at least one CTA an SM."""
    import inspect

    assert list(inspect.signature(gemv.k7_plan).parameters) == ["k", "n", "itemsize"]
    twb, split, kc, br = gemv.k7_plan(k, n, itemsize)
    assert twb in (16, 32, 64, 128) and split in (1, 2, 4, 8)
    assert kc % 8 == 0 and kc * split >= k > kc * (split - 1)
    assert kc % br == 0 and br % 8 == 0 and br <= 256 and twb * br <= 16384
    row = n * itemsize
    tiles = -(-row // twb)
    cover = np.zeros((kc * split, tiles), np.int32)
    for rank in range(split):
        for j in range(kc // br):
            cover[rank * kc + j * br:rank * kc + (j + 1) * br, :] += 1
    assert (cover[:k] == 1).all()
    if (k, n) in GPT2_LARGE.values() and (k, n) != GPT2_LARGE["adapter_fc1"]:
        assert tiles * split >= 132


@pytest.mark.parametrize("d,h,itemsize", [(256, 1024, 1), (1280, 5120, 1), (32, 128, 1),
                                          (128, 192, 1), (768, 3072, 1), (1600, 6400, 1)])
def test_fused_mlp_legal_equals_the_jax_packages(d, h, itemsize):
    from summer_clip_tpu.ops import gemv as jgemv

    assert gemv.fused_mlp_legal(d, h, itemsize) == jgemv.fused_mlp_legal(d, h, itemsize)


def _route_spy(monkeypatch):
    """Count the calls of the K7 / K10 wrappers that ``qdot`` / ``qmlp`` make
    (on the CPU the wrappers run their plain versions)."""
    calls = {"k7": 0, "k10": 0}
    k7, k10 = gemv.streamed_qmatmul, gemv.fused_qmlp

    def spy7(*a, **kw):
        calls["k7"] += 1
        return k7(*a, **kw)

    def spy10(*a, **kw):
        calls["k10"] += 1
        return k10(*a, **kw)

    monkeypatch.setattr(gemv, "streamed_qmatmul", spy7)
    monkeypatch.setattr(gemv, "fused_qmlp", spy10)
    return calls


@pytest.mark.parametrize("lead,k,n,quant,env,to_k7", [
    ((1, 1), 256, 768, True, None, True),       # one decode row
    ((2, 4), 256, 768, True, None, True),       # 8 rows in all
    ((3, 3), 256, 768, True, None, False),      # 9 rows: the wide way
    ((1, 4), 32, 96, True, None, False),        # N < 128: not tile-legal (test-gpt's width)
    ((1, 4), 48, 256, True, None, False),       # K off the int8 tile
    ((1, 1), 256, 768, True, "0", False),       # the switch
    ((1, 2), 256, 768, False, None, True),      # a plain f32 leaf at decode shape
    ((4, 4), 256, 768, False, None, False),     # a plain leaf, wide: one product in dtype
])
def test_qdot_routes_and_computes_like_the_jax_package(monkeypatch, lead, k, n, quant, env, to_k7):
    import jax.numpy as jnp

    from summer_clip_tpu.ops import gemv as jgemv

    if env is None:
        monkeypatch.delenv("SUMMER_CLIP_GEMV", raising=False)
    else:
        monkeypatch.setenv("SUMMER_CLIP_GEMV", env)
    rng = np.random.default_rng(k + n + len(lead))
    x = rng.standard_normal((*lead, k)).astype(np.float32)
    w, scale = _weights(rng, k, n, "int8" if quant else "f32")
    jleaf = {"q": jnp.asarray(w), "scale": jnp.asarray(scale)} if quant else jnp.asarray(w)
    tleaf = gemv.QLeaf(torch.from_numpy(w), torch.from_numpy(scale)) if quant else torch.from_numpy(w)

    jcalls = {"k7": 0}
    jk7 = jgemv.streamed_qmatmul
    monkeypatch.setattr(jgemv, "streamed_qmatmul",
                        lambda *a, **kw: (jcalls.__setitem__("k7", jcalls["k7"] + 1), jk7(*a, **kw))[1])
    want = jgemv.qdot(jnp.asarray(x), jleaf, jnp.float32)
    calls = _route_spy(monkeypatch)
    got = gemv.qdot(torch.from_numpy(x), tleaf, torch.float32)
    assert calls["k7"] == jcalls["k7"] == int(to_k7)
    assert tuple(got.shape) == (*lead, n)
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("rows,d,h", [(1, 128, 512), (8, 128, 512), (3, 256, 1024)])
def test_k10_plain_version_matches_jax_kernel_and_reference(rows, d, h):
    import jax.numpy as jnp

    from summer_clip_tpu.ops import gemv as jgemv

    rng = np.random.default_rng(rows + d + h)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    (w1, s1), (w2, s2) = _quant(rng, d, h), _quant(rng, h, d)
    b1 = (rng.standard_normal(h) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(d) * 0.1).astype(np.float32)
    args = (x, w1, s1, b1, w2, s2, b2)
    want_kernel = jgemv.fused_qmlp(*map(jnp.asarray, args), interpret=True)
    want_ref = jgemv.fused_qmlp_reference(*map(jnp.asarray, args))
    for fn in (gemv.fused_qmlp_reference, gemv.fused_qmlp):
        got = fn(*map(torch.from_numpy, args)).numpy()
        _close(got, want_ref, 1e-4)
        _close(got, want_kernel, 1e-4)
    assert gemv.fused_qmlp.launches == 0


# (D, H) that K10 must plan: the gpt2 family's widths and small test widths at
# the usual ratios, a few others; the ones the JAX rule sends to K10
K10_GRID = sorted({(d, m * d) for d in (128, 256, 384, 512, 640, 768, 1024, 1280, 1536, 2048, 4096)
                   for m in (1, 2, 3, 4, 8)} | {(1280, 1280 * 4 + 128), (16384, 128), (128, 65536)})
K10_LEGAL = [dh for dh in K10_GRID if gemv.fused_mlp_legal(*dh, 1)]


def test_k10_grid_holds_the_main_path_and_test_widths():
    for dh in ((1280, 5120), (1024, 4096), (768, 3072), (256, 1024), (128, 512)):
        assert dh in K10_LEGAL


@pytest.mark.parametrize("d,h", K10_LEGAL)
def test_k10_plan_covers_h_once_with_legal_boxes(d, h):
    """K10's plan is a function of (D, H) alone, never of the rows of x. Its
    clusters cover H exactly once; a cluster's ranks cover D exactly once, as
    w1's rows and as w2's and the output's columns; every TMA box is legal (at
    most 256 rows, a width of 16 to 256 bytes, a multiple of 16) and so is the
    cluster (at most 8 CTAs); a CTA's shared memory stays within 227 KB for
    every count of rows; at gpt2-large every CTA is one of at most 132."""
    import inspect

    assert list(inspect.signature(gemv.k10_plan).parameters) == ["d", "h"]
    plan = gemv.k10_plan(d, h)
    assert plan == gemv.k10_plan(d, h)
    assert 1 <= plan.split <= 8 and plan.kc * plan.split == d and plan.kc % 16 == 0
    hidden = np.zeros(h, np.int32)
    for c in range(plan.clusters):
        hidden[c * plan.hc:(c + 1) * plan.hc] += 1
    assert (hidden == 1).all()
    rows, cols = np.zeros(d, np.int32), np.zeros(d, np.int32)
    for rank in range(plan.split):
        k0 = rank * plan.kc
        for j in range(plan.kc // plan.br1):                    # w1's boxes of this rank
            rows[k0 + j * plan.br1:k0 + (j + 1) * plan.br1] += 1
        for t in range(plan.kc // plan.twb2):                   # w2's column tiles
            cols[k0 + t * plan.twb2:k0 + (t + 1) * plan.twb2] += 1
    assert (rows == 1).all() and (cols == 1).all()
    assert plan.kc % plan.br1 == 0 and plan.kc % plan.twb2 == 0 and plan.hc % plan.br2 == 0
    for width, box_rows in ((plan.hc, plan.br1), (plan.twb2, plan.br2)):
        assert 16 <= width <= 256 and width % 16 == 0 and width & (width - 1) == 0
        assert 1 <= box_rows <= 256
    for r in range(1, gemv.MAX_ROWS + 1):
        assert gemv.k10_smem(plan, r) <= 227 * 1024
    if (d, h) == (1280, 5120):
        assert plan.ctas <= 132


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _gelu_tanh(v):
    c = np.float32(0.7978845608028654)
    inner = c * (v + np.float32(0.044715) * v * v * v)
    return (np.float32(0.5) * v * (np.float32(1.0) + np.tanh(inner))).astype(np.float32)


def _k10_walk(plan, x, w1, s1, b1, w2, s2, b2, hidden=None):
    """K10's plan walked in numpy, f32: each cluster's chunk of hidden units;
    in it each rank's K chunk of the first product, rows in order, the ranks
    added in rank order; s1, b1, gelu_tanh, bf16; each rank's columns of the
    second product, hidden units in order; then each ticketed group of 16
    columns added over the clusters in cluster order, scaled and biased.
    ``hidden``: a (rows, H) hidden to use in place of the walk's own.
    Returns the output and the pre-activation."""
    n, d = x.shape
    h = w1.shape[1]
    xb, w1f, w2f = _bf16(x), w1.astype(np.float32), w2.astype(np.float32)
    s1, b1, s2, b2 = (np.asarray(v, np.float32).reshape(-1) for v in (s1, b1, s2, b2))
    part = np.zeros((plan.clusters, n, d), np.float32)
    pre = np.zeros((n, h), np.float32)
    for c in range(plan.clusters):
        hc = slice(c * plan.hc, (c + 1) * plan.hc)
        t = np.zeros((n, plan.hc), np.float32)
        for rank in range(plan.split):
            acc = np.zeros((n, plan.hc), np.float32)
            for k in range(rank * plan.kc, (rank + 1) * plan.kc):
                acc += xb[:, k:k + 1] * w1f[k, hc]
            t += acc
        t = t * s1[hc] + b1[hc]
        pre[:, hc] = t
        hid = _bf16(_gelu_tanh(t)) if hidden is None else hidden[:, hc]
        for rank in range(plan.split):
            cols = slice(rank * plan.kc, (rank + 1) * plan.kc)
            acc = np.zeros((n, plan.kc), np.float32)
            for j in range(plan.hc):
                acc += hid[:, j:j + 1] * w2f[c * plan.hc + j, cols]
            part[c, :, cols] = acc
    out = np.zeros((n, d), np.float32)
    covered = np.zeros(d, np.int32)
    for g in range(d // 16):
        cols = slice(16 * g, 16 * (g + 1))
        acc = np.zeros((n, 16), np.float32)
        for c in range(plan.clusters):
            acc += part[c, :, cols]
        out[:, cols] = acc * s2[cols] + b2[cols]
        covered[cols] += 1
    assert (covered == 1).all()
    return out, pre


@pytest.mark.parametrize("d,h", [(128, 512), (256, 1024), (768, 3072), (1280, 5120)])
def test_k10_plan_walked_in_numpy_matches_the_plain_version(d, h):
    """The order of K10's sums, walked in numpy on the plan, computes the plain
    version's function: the pre-activation within 1e-5 of its largest (f32 sums
    in another order); fed the plain version's bf16 hidden, the output within
    1e-5 of the largest; with its own hidden within 1e-4 (a hidden that differs
    in its last f32 bit may round to the neighbouring bf16 value, as in the
    JAX comparisons above). Row 0 alone gives the bits it gives among 8."""
    rng = np.random.default_rng(d + h)
    x = rng.standard_normal((8, d)).astype(np.float32)
    (w1, s1), (w2, s2) = _quant(rng, d, h), _quant(rng, h, d)
    b1 = (rng.standard_normal(h) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(d) * 0.1).astype(np.float32)
    args = (x, w1, s1, b1, w2, s2, b2)
    plan = gemv.k10_plan(d, h)
    targs = list(map(torch.from_numpy, args))
    want = gemv.fused_qmlp_reference(*targs).numpy()
    want_pre = (gemv.matmul_reference(targs[0], targs[1], targs[2]) + targs[3]).numpy()
    hidden = _bf16(torch.nn.functional.gelu(torch.from_numpy(want_pre), approximate="tanh").numpy())
    got, pre = _k10_walk(plan, *args)
    _close(pre, want_pre, 1e-5)
    _close(_k10_walk(plan, *args, hidden=hidden)[0], want, 1e-5)
    _close(got, want, 1e-4)
    alone, _ = _k10_walk(plan, x[:1], *args[1:])
    np.testing.assert_array_equal(alone[0], got[0])


def test_k10_plain_version_keeps_the_hidden_in_f32():
    """The hidden is not rounded to a model type between the products: with a
    bf16 rounding of the pre-activation the result moves by more than the
    plain version's distance to the JAX kernel."""
    rng = np.random.default_rng(5)
    d, h = 128, 512
    x = torch.from_numpy(rng.standard_normal((2, d)).astype(np.float32))
    (w1, s1), (w2, s2) = _quant(rng, d, h), _quant(rng, h, d)
    w1, s1, w2, s2 = map(torch.from_numpy, (w1, s1, w2, s2))
    b1, b2 = torch.zeros(h), torch.zeros(d)
    got = gemv.fused_qmlp_reference(x, w1, s1, b1, w2, s2, b2)
    t = gemv.matmul_reference(x, w1, s1).to(torch.bfloat16).float()     # the rounding K10 avoids
    rounded = gemv.matmul_reference(torch.nn.functional.gelu(t, approximate="tanh"), w2, s2)
    assert float((got - rounded).abs().max()) > 2e-4 * float(got.abs().max())


@pytest.mark.parametrize("lead,opt_in,gemv_env,quant,fused", [
    ((1, 1), "1", None, True, True), ((2, 4), "1", None, True, True),
    ((3, 3), "1", None, True, False),         # more than 8 rows
    ((1, 1), None, None, True, False),        # off by default
    ((1, 1), "1", "0", True, False),          # the K7 switch turns K10 off too
    ((1, 1), "1", None, False, False),        # plain leaves
])
def test_qmlp_routes_and_computes_like_the_jax_package(monkeypatch, lead, opt_in, gemv_env, quant,
                                                       fused):
    import jax.numpy as jnp

    from summer_clip_tpu.ops import gemv as jgemv

    for name, val in (("SUMMER_CLIP_FUSED_MLP", opt_in), ("SUMMER_CLIP_GEMV", gemv_env)):
        if val is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, val)
    d, h = 128, 512
    rng = np.random.default_rng(17)
    x = rng.standard_normal((*lead, d)).astype(np.float32)
    (w1, s1), (w2, s2) = _quant(rng, d, h), _quant(rng, h, d)
    b1 = (rng.standard_normal(h) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(d) * 0.1).astype(np.float32)
    if quant:
        j1, j2 = ({"q": jnp.asarray(w), "scale": jnp.asarray(s)} for w, s in ((w1, s1), (w2, s2)))
        t1, t2 = (gemv.QLeaf(torch.from_numpy(w), torch.from_numpy(s)) for w, s in ((w1, s1), (w2, s2)))
    else:
        j1, j2 = jnp.asarray(w1 * s1), jnp.asarray(w2 * s2)
        t1, t2 = torch.from_numpy(w1 * s1), torch.from_numpy(w2 * s2)
    want = jgemv.qmlp(jnp.asarray(x), j1, jnp.asarray(b1), j2, jnp.asarray(b2), jnp.float32)
    calls = _route_spy(monkeypatch)
    got = gemv.qmlp(torch.from_numpy(x), t1, torch.from_numpy(b1), t2, torch.from_numpy(b2),
                    torch.float32)
    assert (got is not None) == (want is not None) == fused
    assert calls["k10"] == int(fused)
    if fused:
        assert tuple(got.shape) == (*lead, d)
        _close(got.numpy(), want, 1e-4)


def test_gather_rows_on_plain_and_int8_leaves_matches_jax():
    import jax.numpy as jnp

    from summer_clip_tpu.ops import gemv as jgemv

    rng = np.random.default_rng(3)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    scale = (np.abs(table).max(1, keepdims=True) / 127.0).astype(np.float32)     # per row
    q = np.clip(np.round(table / scale), -127, 127).astype(np.int8)
    ids = rng.integers(0, 50, (3, 5))
    want = jgemv.gather_rows({"q": jnp.asarray(q), "scale": jnp.asarray(scale)}, jnp.asarray(ids))
    leaf = gemv.QLeaf(torch.from_numpy(q), torch.from_numpy(scale))
    got = gemv.gather_rows(leaf, torch.from_numpy(ids))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 5, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gemv.gather_rows(torch.from_numpy(table), torch.from_numpy(ids)).numpy(),
                                  np.asarray(jgemv.gather_rows(jnp.asarray(table), jnp.asarray(ids))))
    assert gemv.is_qleaf(leaf) and not gemv.is_qleaf(leaf.q) and not gemv.is_qleaf({"q": 1, "scale": 2})
    with pytest.raises(TypeError, match="int8"):
        gemv.QLeaf(torch.zeros(2, 2), torch.ones(1, 2))


def test_wrappers_launch_or_raise_off_the_cpu():
    """No plain version for a tensor that is not on the CPU: the meta device
    reaches the kernel path's checks and raises."""
    x = torch.empty(2, 256, device="meta")
    w = torch.empty(256, 256, dtype=torch.int8, device="meta")
    s = torch.empty(1, 256, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        gemv.streamed_qmatmul(x, w, s)
    with pytest.raises(ValueError, match="CUDA"):
        gemv.fused_qmlp(x, w, s, s.reshape(-1), w, s, s.reshape(-1))
    assert gemv.streamed_qmatmul.launches == 0 and gemv.fused_qmlp.launches == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("wtype", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("rows,k,n", [(1, 256, 768), (8, 1280, 1280), (3, 5120, 1280), (5, 64, 200),
                                      (2, 1280, 49408), (7, 96, 130), (2, 16384, 256)])
def test_cuda_k7_matches_plain(rows, k, n, wtype):
    _cuda()
    rng = np.random.default_rng(rows + k + n)
    x = torch.from_numpy(rng.standard_normal((rows, k)).astype(np.float32)).cuda()
    w, scale = _weights(rng, k, n, wtype)
    w = _torch_weight(w, wtype).cuda()
    scale = None if scale is None else torch.from_numpy(scale).cuda()
    before = gemv.streamed_qmatmul.launches
    got = gemv.streamed_qmatmul(x, w, scale)
    torch.cuda.synchronize()
    assert gemv.streamed_qmatmul.launches == before + 1
    want = gemv.matmul_reference(x, w, scale)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert torch.equal(got, gemv.streamed_qmatmul(x, w, scale))               # repeats bit for bit
    assert torch.equal(got[:1], gemv.streamed_qmatmul(x[:1], w, scale))       # whoever rides along


@pytest.mark.cuda
@pytest.mark.parametrize("pdl", [True, False])
def test_cuda_k7_reads_x_after_a_slow_predecessor(monkeypatch, pdl):
    """With programmatic dependent launch K7 asks for its weights before the
    kernel before it has ended, and must read x only after that kernel's
    writes: x filled with NaN, then written by a slow reduction (or by the K7
    whose output it is), gives the bits of a synchronised call."""
    _cuda()
    monkeypatch.setattr(gemv, "PDL", pdl)
    gen = torch.Generator(device="cuda").manual_seed(3)
    k, n = 1280, 5120
    w1 = torch.randint(-127, 128, (k, n), dtype=torch.int8, device="cuda", generator=gen)
    w2 = torch.randint(-127, 128, (n, k), dtype=torch.int8, device="cuda", generator=gen)
    s1, s2 = torch.full((1, n), 1e-3, device="cuda"), torch.full((1, k), 1e-3, device="cuda")
    big = torch.randn((4, n, 256), device="cuda", generator=gen)
    x0 = torch.randn((4, k), device="cuda", generator=gen)
    want_sum = gemv.streamed_qmatmul(big.sum(-1), w2, s2)
    torch.cuda.synchronize()
    hidden = gemv.streamed_qmatmul(x0, w1, s1)
    torch.cuda.synchronize()
    want_chain = gemv.streamed_qmatmul(hidden, w2, s2)
    torch.cuda.synchronize()
    xbuf = torch.empty((4, n), device="cuda")
    for _ in range(10):
        xbuf.fill_(float("nan"))
        torch.sum(big, dim=-1, out=xbuf)
        assert torch.equal(gemv.streamed_qmatmul(xbuf, w2, s2), want_sum)
        del hidden
        torch.full((4, n), float("nan"), device="cuda")    # the block the next output takes
        hidden = gemv.streamed_qmatmul(x0, w1, s1)
        assert torch.equal(gemv.streamed_qmatmul(hidden, w2, s2), want_chain)


@pytest.mark.cuda
def test_cuda_k7_captures_into_a_graph():
    """A chain of K7 launches (programmatic dependent launch on) captured into
    a CUDA graph gives the eager chain's bits."""
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(5)
    w1 = torch.randint(-127, 128, (1280, 3840), dtype=torch.int8, device="cuda", generator=gen)
    w2 = torch.randint(-127, 128, (3840, 1280), dtype=torch.int8, device="cuda", generator=gen)
    s1, s2 = torch.full((1, 3840), 1e-3, device="cuda"), torch.full((1, 1280), 1e-3, device="cuda")
    x = torch.randn((2, 1280), device="cuda", generator=gen)
    want = gemv.streamed_qmatmul(gemv.streamed_qmatmul(x, w1, s1), w2, s2)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = gemv.streamed_qmatmul(gemv.streamed_qmatmul(x, w1, s1), w2, s2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,h", [(1, 1280, 5120), (8, 1280, 5120), (3, 256, 1024)])
def test_cuda_k10_matches_plain(rows, d, h):
    _cuda()
    rng = np.random.default_rng(rows + d)
    x = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32)).cuda()
    (w1, s1), (w2, s2) = _quant(rng, d, h), _quant(rng, h, d)
    b1 = (rng.standard_normal(h) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(d) * 0.1).astype(np.float32)
    args = [x] + [torch.from_numpy(a).cuda() for a in (w1, s1, b1, w2, s2, b2)]
    got = gemv.fused_qmlp(*args)
    torch.cuda.synchronize()
    want = gemv.fused_qmlp_reference(*args)
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())
    assert torch.equal(got, gemv.fused_qmlp(*args))


def _k10_args(rows, d, h, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32)).cuda()
    (w1, s1), (w2, s2) = _quant(rng, d, h), _quant(rng, h, d)
    b1 = (rng.standard_normal(h) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(d) * 0.1).astype(np.float32)
    return [x] + [torch.from_numpy(a).cuda() for a in (w1, s1, b1, w2, s2, b2)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", range(1, 9))
def test_cuda_k10_row_alone_and_repeat_bit_for_bit(rows):
    """At gpt2-large width, one launch a call; every row gives the bits it
    gives alone, and two runs give the same bits."""
    _cuda()
    x, *weights = _k10_args(rows, 1280, 5120, 40 + rows)
    before = gemv.fused_qmlp.launches
    got = gemv.fused_qmlp(x, *weights)
    torch.cuda.synchronize()
    assert gemv.fused_qmlp.launches == before + 1
    assert torch.equal(got, gemv.fused_qmlp(x, *weights))
    for r in range(rows):
        assert torch.equal(got[r:r + 1], gemv.fused_qmlp(x[r:r + 1], *weights))


@pytest.mark.cuda
@pytest.mark.parametrize("pdl", [True, False])
def test_cuda_k10_reads_x_after_a_slow_predecessor(monkeypatch, pdl):
    """With programmatic dependent launch K10 asks for its weights before the
    kernel before it has ended, and must read x only after that kernel's
    writes: x filled with NaN, then written by a slow reduction (or by the K10
    whose output it is), gives the bits of a synchronised call."""
    _cuda()
    monkeypatch.setattr(gemv, "PDL", pdl)
    x0, w1, s1, b1, w2, s2, b2 = _k10_args(4, 1280, 5120, 8)
    gen = torch.Generator(device="cuda").manual_seed(9)
    big = torch.randn((4, 1280, 512), device="cuda", generator=gen)
    want_sum = gemv.fused_qmlp(big.sum(-1), w1, s1, b1, w2, s2, b2)
    torch.cuda.synchronize()
    y = gemv.fused_qmlp(x0, w1, s1, b1, w2, s2, b2)
    torch.cuda.synchronize()
    want_chain = gemv.fused_qmlp(y, w1, s1, b1, w2, s2, b2)
    torch.cuda.synchronize()
    xbuf = torch.empty((4, 1280), device="cuda")
    for _ in range(10):
        xbuf.fill_(float("nan"))
        torch.sum(big, dim=-1, out=xbuf)
        assert torch.equal(gemv.fused_qmlp(xbuf, w1, s1, b1, w2, s2, b2), want_sum)
        del y
        torch.full((4, 1280), float("nan"), device="cuda")    # the block the next output takes
        y = gemv.fused_qmlp(x0, w1, s1, b1, w2, s2, b2)
        assert torch.equal(gemv.fused_qmlp(y, w1, s1, b1, w2, s2, b2), want_chain)


@pytest.mark.cuda
def test_cuda_k10_captures_into_a_graph():
    """A chain of K10 launches (programmatic dependent launch on) captured into
    a CUDA graph gives the eager chain's bits, replay after replay: the tickets
    are back at zero after every launch."""
    _cuda()
    x, w1, s1, b1, w2, s2, b2 = _k10_args(2, 1280, 5120, 12)
    want = gemv.fused_qmlp(gemv.fused_qmlp(x, w1, s1, b1, w2, s2, b2), w1, s1, b1, w2, s2, b2)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = gemv.fused_qmlp(gemv.fused_qmlp(x, w1, s1, b1, w2, s2, b2), w1, s1, b1, w2, s2, b2)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_gemv_kernels_refuse_what_they_do_not_take():
    _cuda()
    w = torch.zeros(256, 256, dtype=torch.int8, device="cuda")
    s = torch.ones(1, 256, device="cuda")
    with pytest.raises(ValueError, match="expected"):
        gemv.streamed_qmatmul(torch.zeros(9, 256, device="cuda"), w, s)
    with pytest.raises(NotImplementedError, match="backward"):
        gemv.streamed_qmatmul(torch.zeros(1, 256, device="cuda", requires_grad=True), w, s)
    with pytest.raises(TypeError, match="int8"):
        gemv.fused_qmlp(torch.zeros(1, 256, device="cuda"), w.float(), s, s, w, s, s)
