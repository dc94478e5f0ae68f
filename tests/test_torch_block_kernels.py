"""K5 fused_ln_attn and K6 fused_ln_mlp of the port against the JAX kernels.

The JAX side runs the Pallas kernels in interpret mode on the CPU; the port
side runs the wrappers on CPU tensors, i.e. their plain PyTorch versions. The
same numpy inputs go to both. f32 comparisons hold to 1e-5 (summation order
only); the bf16 comparison holds the rounding points to 2 bf16 ulps.
The ``cuda`` tests compare the CUDA kernels with their plain versions on a
card and skip without one.
"""

import numpy as np
import pytest
import torch

from summer_clip_torch.ops import block_kernels as bk

D, HEADS = 512, 8   # head dim 64 and a ViT-B width, as the CUDA kernels take


def _attn_inputs(rng, d):
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    return dict(ln_w=1.0 + f(d, scale=0.1), ln_b=f(d, scale=0.1),
                wq=f(d, d, scale=d ** -0.5), bq=f(d, scale=0.02),
                wk=f(d, d, scale=d ** -0.5), bk=f(d, scale=0.02),
                wv=f(d, d, scale=d ** -0.5), bv=f(d, scale=0.02),
                wo=f(d, d, scale=d ** -0.5), bo=f(d, scale=0.02))


def _port_attn_args(p, dtype=torch.float32):
    # contiguous, as the CUDA wrappers require (concatenated transposes are not)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)  # noqa: E731
    in_w = np.concatenate([p["wq"].T, p["wk"].T, p["wv"].T])
    in_b = np.concatenate([p["bq"], p["bk"], p["bv"]])
    return (torch.from_numpy(p["ln_w"]), torch.from_numpy(p["ln_b"]), t(in_w), t(in_b),
            t(np.ascontiguousarray(p["wo"].T)), t(p["bo"]))


@pytest.mark.parametrize("causal,t", [(False, 13), (True, 13), (True, 77)])
def test_ln_attn_matches_jax_kernel(causal, t):
    import jax.numpy as jnp

    from summer_clip_tpu.ops.block_kernels import fused_ln_attn as jax_fused_ln_attn

    rng = np.random.default_rng(1)
    p = _attn_inputs(rng, D)
    x = rng.standard_normal((2, t, D)).astype(np.float32)
    want = np.asarray(jax_fused_ln_attn(
        jnp.asarray(x), *(jnp.asarray(p[k]) for k in
                          ("ln_w", "ln_b", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")),
        num_heads=HEADS, causal=causal, interpret=True))
    got = bk.fused_ln_attn(torch.from_numpy(x), *_port_attn_args(p), num_heads=HEADS,
                           causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _mlp_inputs(rng, d):
    h = 4 * d
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    return dict(ln_w=1.0 + f(d, scale=0.1), ln_b=f(d, scale=0.1),
                w1=f(d, h, scale=d ** -0.5), b1=f(h, scale=0.02),
                w2=f(h, d, scale=h ** -0.5), b2=f(d, scale=0.02))


def _port_mlp_args(p, dtype=torch.float32):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)  # noqa: E731
    return (torch.from_numpy(p["ln_w"]), torch.from_numpy(p["ln_b"]), t(p["w1"].T), t(p["b1"]),
            t(p["w2"].T), t(p["b2"]))


def _jax_mlp(x, p, dtype):
    import jax.numpy as jnp

    from summer_clip_tpu.ops.block_kernels import fused_ln_mlp as jax_fused_ln_mlp

    return np.asarray(jax_fused_ln_mlp(
        jnp.asarray(x, dtype), jnp.asarray(p["ln_w"]), jnp.asarray(p["ln_b"]),
        *(jnp.asarray(p[k], dtype) for k in ("w1", "b1", "w2", "b2")),
        interpret=True).astype(jnp.float32))


def test_ln_mlp_matches_jax_kernel():
    rng = np.random.default_rng(2)
    p = _mlp_inputs(rng, D)
    x = rng.standard_normal((2, 13, D)).astype(np.float32)
    want = _jax_mlp(x, p, np.float32)
    got = bk.fused_ln_mlp(torch.from_numpy(x), *_port_mlp_args(p)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_ln_mlp_bf16_rounding_points_match_jax_kernel():
    """bf16: c_fc rounded, bias in bf16, bf16(1.702) * h, f32 sigmoid rounded,
    product in bf16 -- the JAX kernel's order (ops/block_kernels.py:98-110)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    p = _mlp_inputs(rng, D)
    x = rng.standard_normal((2, 13, D)).astype(np.float32)
    want = _jax_mlp(x, p, jnp.bfloat16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = bk.fused_ln_mlp(xb, *_port_mlp_args(p, torch.bfloat16)).float().numpy()
    # the two frameworks' bf16 CPU products sum in other orders, so a rounded
    # intermediate may land one bf16 ulp apart: most outputs are identical,
    # none is more than one ulp of the largest outputs (2^-6 in [2, 4)) off
    diff = np.abs(got - want)
    assert (diff == 0).mean() > 0.8
    assert diff.max() <= 2.0 ** -6
    assert diff.mean() <= 1e-3


def test_quick_gelu_rounds_its_constant_to_the_activation_dtype():
    x = torch.tensor([1.0, -2.5, 3.0], dtype=torch.bfloat16)
    c = torch.tensor(1.702, dtype=torch.bfloat16)
    assert float(c) == 1.703125
    want = x * torch.sigmoid((c * x).float()).to(torch.bfloat16)
    assert torch.equal(bk.quick_gelu(x), want)


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel path, which raises
    here instead of running the plain version."""
    x = torch.empty(2, 13, D, dtype=torch.bfloat16, device="meta")
    w = torch.empty(D, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        bk.fused_ln_attn(x, w, w, torch.empty(3 * D, D, device="meta"),
                         torch.empty(3 * D, device="meta"), torch.empty(D, D, device="meta"),
                         w, num_heads=HEADS)
    with pytest.raises(ValueError, match="CUDA"):
        bk.fused_ln_mlp(x, w, w, torch.empty(4 * D, D, device="meta"),
                        torch.empty(4 * D, device="meta"), torch.empty(D, 4 * D, device="meta"), w)
    with pytest.raises(ValueError, match="head dim"):
        bk.fused_ln_attn(x, w, w, w, w, w, w, num_heads=4)
    assert bk.fused_ln_attn.launches == 0 and bk.fused_ln_mlp.launches == 0


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from summer_clip_torch.ops import _lib

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _lib.build("block_kernels")


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("causal,t,d", [(False, 197, 768), (False, 50, 768), (True, 77, 512),
                                        (False, 5, 512), (True, bk.MAX_T, 512),
                                        (False, 257, 768), (True, 577, 512), (False, 61, 320)])
def test_cuda_kernels_match_plain(cuda, causal, t, d):
    """K5 and K6 against their plain versions: 591, 150, 231, 15, 1920, 771,
    1731 and 183 rows leave the last 128-row GEMM tile ragged; T up to K4's
    640, and D = 320 (five heads: no GEMM tile divides 960 or 320). Two runs
    give the same bits, and the last sequence alone the bits it has among
    the others."""
    rng = np.random.default_rng(4)
    pa, pm = _attn_inputs(rng, d), _mlp_inputs(rng, d)
    x = torch.from_numpy(rng.standard_normal((3, t, d)).astype(np.float32)).to(cuda, torch.bfloat16)
    attn = [a.to(cuda) for a in _port_attn_args(pa, torch.bfloat16)]
    mlp = [a.to(cuda) for a in _port_mlp_args(pm, torch.bfloat16)]
    for kern, plain, args, kw in (
            (bk.fused_ln_attn, bk.ln_attn_reference, attn, dict(num_heads=d // 64, causal=causal)),
            (bk.fused_ln_mlp, bk.ln_mlp_reference, mlp, {})):
        got = kern(x, *args, **kw)
        again = kern(x, *args, **kw)
        alone = kern(x[-1:].contiguous(), *args, **kw)
        want = plain(x, *args, **kw).float()
        torch.cuda.synchronize()
        assert (got.float() - want).abs().max() <= 0.0625
        assert (got.float() - want).abs().mean() <= 2e-3
        assert torch.equal(got, again) and torch.equal(alone[0], got[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,scale", [(300, 256, 64, 1.0), (300, 256, 64, 12.0),
                                         (1000, 512, 128, 60.0)])
def test_cuda_gelu_epilogue_is_quick_gelu_within_a_sigmoid_ulp(cuda, m, n, k, scale):
    """``block_gemm``'s QuickGELU epilogue against the plain ``quick_gelu``
    (``torch.sigmoid`` in f32) on its bias epilogue's output, at |1.702 h|
    from near 0 to far past the special-function unit's exponent range: its
    f32 sigmoid, a few ulps from torch's, may round to the next bf16, which
    moves an output by at most |h| 2^-7 with the product's rounding; at
    activations of unit scale at most one output in a thousand moves."""
    from summer_clip_torch.ops import _lib

    gen = torch.Generator().manual_seed(5)
    a = torch.randn((m, k), generator=gen).to(cuda, torch.bfloat16)
    w = (torch.randn((n, k), generator=gen) * scale * k ** -0.5).to(cuda, torch.bfloat16)
    b = (torch.randn((n,), generator=gen) * 0.02).to(cuda, torch.bfloat16)
    lib, stream = bk._lib_block(), _lib.torch_stream()
    h = bk._gemm(lib, a, w, b, "bias", stream)
    got, want = bk._gemm(lib, a, w, b, "gelu", stream), bk.quick_gelu(h)
    assert ((got.float() - want.float()).abs() <= h.float().abs() * 2.0 ** -7).all()
    if scale == 1.0:
        assert (got != want).float().mean() <= 1e-3


@pytest.mark.parametrize("mode", ["block", "mlp", "xla"])
@pytest.mark.parametrize("d", [256, 512, 768, 1024])
def test_routes_match_the_jax_gates_over_a_grid(d, mode, monkeypatch):
    """``attn_route`` / ``mlp_route`` (the JAX gates and what K5, K6 and K9
    take) give the JAX package's own ``_fuse_attn_ok`` / ``_fuse_mlp_ok`` and
    ``_mlp_dispatch`` route at every T up to past ``SHORT_MAX_T``, head dim
    64: K5 takes every T <= 640 that the JAX gate admits (it took T <= 240
    before its attention became K4's device code)."""
    import summer_clip_tpu.models.clip.modeling as jm
    from summer_clip_tpu.ops import block_kernels as jbk

    import summer_clip_torch.models.clip.modeling as pm

    monkeypatch.setattr(pm, "FUSED_BLOCK_MODE", mode)
    monkeypatch.setattr(jm, "FUSED_BLOCK_MODE", mode)
    monkeypatch.setattr(jm, "FUSED_BLOCK_FORCE", True)  # the backend check, not the geometry
    heads, fused = d // 64, []
    chunked = 2 * d * 4 * d * 2 > jbk.FUSED_MLP_MAX_WEIGHT_BYTES
    for t in (1, 7, 77, 197, 240, 241, 257, 320, 400, 431, 480, 513, 577, 600, 640, 641, 700):
        jax_attn = "k5" if jm._fuse_attn_ok(d, t, heads, 2) else "module"
        jax_mlp = ("k9" if chunked else "k6") if jm._fuse_mlp_ok(d, t, heads, 2) else "plain"
        assert (pm.attn_route(d, t, heads), pm.mlp_route(d, t, heads, 4 * d)) == (jax_attn, jax_mlp)
        assert bk.fused_attn_ok(t, d, heads) == (0 < t <= 640)
        if jax_attn == "k5":
            fused.append(t)
    if mode == "block" and d in (512, 768):   # the grid reaches past the old limit of 240
        assert any(t > 240 for t in fused)


@pytest.mark.parametrize("m,n,k", [(6304, 2304, 768), (6304, 768, 768), (6304, 3072, 768),
                                   (6304, 768, 3072), (19712, 1536, 512), (19712, 512, 2048),
                                   (77000, 768, 3072), (591, 960, 320), (15, 2048, 512)])
def test_gemm_tile_plan_covers_every_output_once_at_least_cost(m, n, k):
    """The tile :func:`gemm_tile` picks has the least modelled time of the
    three (waves x the bytes a tile takes in, fill and epilogue counted as two
    more stages), and the kernel's block order (column tiles of a row tile
    next to each other) covers every output element exactly once."""
    sms = 132
    bn = bk.gemm_tile(m, n, k, sms)
    stages = -(-k // bk.GEMM_DEPTH) + 2

    def modelled(tile):
        waves = -(-(-(-m // bk.GEMM_ROWS) * -(-n // tile)) // sms)
        return waves * stages * (bk.GEMM_ROWS + tile) * bk.GEMM_DEPTH * 2

    assert modelled(bn) == min(modelled(tile) for tile in bk.GEMM_TILES)
    ntn = -(-n // bn)
    cover = np.zeros((m, n), np.int32)
    for block in range(-(-m // bk.GEMM_ROWS) * ntn):
        m0, n0 = block // ntn * bk.GEMM_ROWS, block % ntn * bn
        cover[m0:m0 + bk.GEMM_ROWS, n0:n0 + bn] += 1
    assert (cover == 1).all()


def test_gemm_tile_fills_the_waves_of_the_narrow_products():
    """At the ViT-B/16 image shape (6304 rows: 50 row tiles) the 768-column
    products would take 150 tiles of 256 columns for 132 SMs (two waves, the
    second 14% full); 192 columns make 200 tiles. Where the waves are many
    (19712 or 77000 rows) every product keeps 256 columns."""
    assert bk.gemm_tile(6304, 768, 3072) == 192 and bk.gemm_tile(6304, 768, 768) == 192
    assert bk.gemm_tile(6304, 3072, 768) == 256 and bk.gemm_tile(6304, 2304, 768) == 256
    for m, d in ((19712, 512), (19712, 768), (77000, 768)):
        for n, k in ((3 * d, d), (d, d), (4 * d, d), (d, 4 * d)):
            assert bk.gemm_tile(m, n, k) == 256
