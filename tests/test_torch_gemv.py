"""K7 / K10 (weight-streaming products) and their routing, against the JAX package.

The JAX side runs ``streamed_qmatmul`` / ``fused_qmlp`` in Pallas interpret
mode and their ``*_reference``; the port runs its wrappers on CPU tensors, i.e.
the plain versions. Same numpy inputs. Every product of a bf16 and an int8 or
bf16 value is exact in f32, so the two sides differ by the order of their f32
sums only: rtol 1e-5 of the largest output. K10's hidden is rounded to bf16
before the second product; a hidden that differs in its last f32 bit may round
to the neighbouring bf16 value (2^-8 relative, one term of H), hence 1e-4
there. The ``cuda`` tests compare the CUDA kernels with the plain versions on a
card and skip without one.
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
