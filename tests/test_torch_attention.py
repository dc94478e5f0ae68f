"""K4 / K12 (short attention) and ``multi_head_attention`` of the port against
the JAX package.

The JAX side runs ``short_attention_packed`` / ``short_attention`` in Pallas
interpret mode and ``mha_reference`` on the CPU; the port runs its wrappers on
CPU tensors, i.e. the plain version. Same numpy inputs in f32: both compute
f32 scores, an exact softmax and an f32 PV product, so they agree to 2e-5 (sums
in another order). The ``cuda`` tests compare the CUDA kernels with the plain
version in bf16 on a card and skip without one.
"""

import numpy as np
import pytest
import torch

from summer_clip_torch.ops import attention as at

HD = 64
TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [50, 77, 257])
def test_packed_matches_jax_kernel_and_reference(t, causal):
    import jax.numpy as jnp

    from summer_clip_tpu.ops import attention as jat

    heads = 2
    q, k, v = _qkv(t, (2, t, heads * HD))
    got = at.short_attention_packed(*map(torch.from_numpy, (q, k, v)), num_heads=heads,
                                    causal=causal).numpy()
    want_kernel = np.asarray(jat.short_attention_packed(
        *map(jnp.asarray, (q, k, v)), num_heads=heads, causal=causal, interpret=True))

    def split(x):
        return jnp.asarray(x).reshape(2, t, heads, HD).transpose(0, 2, 1, 3)

    mask = jat._causal_bias(t, t) if causal else None
    want_ref = np.asarray(jat.mha_reference(split(q), split(k), split(v), mask=mask)
                          .transpose(0, 2, 1, 3).reshape(2, t, heads * HD))
    np.testing.assert_allclose(got, want_kernel, **TOL)
    np.testing.assert_allclose(got, want_ref, **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [50, 77, 257])
def test_unpacked_matches_jax_kernel(t, causal):
    import jax.numpy as jnp

    from summer_clip_tpu.ops import attention as jat

    q, k, v = _qkv(100 + t, (4, t, HD))
    got = at.short_attention(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
    want = np.asarray(jat.short_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                          interpret=True))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kwargs", [dict(), dict(causal=True), dict(causal=True, q_offset=3),
                                    dict(mask=True)])
def test_multi_head_attention_matches_jax(kwargs):
    import jax.numpy as jnp

    from summer_clip_tpu.ops import attention as jat

    rng = np.random.default_rng(3)
    tq, tk = (5, 8) if "q_offset" in kwargs else (8, 8)
    q = rng.standard_normal((2, tq, 2 * HD)).astype(np.float32)
    k, v = (rng.standard_normal((2, tk, 2 * HD)).astype(np.float32) for _ in range(2))
    kw_j, kw_t = dict(kwargs), dict(kwargs)
    if kwargs.get("mask"):
        m = (rng.standard_normal((tq, tk)) * 2).astype(np.float32)
        kw_j["mask"], kw_t["mask"] = jnp.asarray(m), torch.from_numpy(m)
    want = np.asarray(jat.multi_head_attention(*map(jnp.asarray, (q, k, v)), num_heads=2, **kw_j))
    got = at.multi_head_attention(*map(torch.from_numpy, (q, k, v)), num_heads=2, **kw_t).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_bf16_plain_version_rounds_probabilities_like_jax():
    """In bf16 both plain versions round p / l to bf16 before the PV product;
    they differ by bf16 output rounding only (one ulp of an output < 2: 2^-7)."""
    import jax.numpy as jnp

    from summer_clip_tpu.ops import attention as jat

    q, k, v = _qkv(9, (3, 40, HD))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = at.mha_reference(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    want = jat.mha_reference(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=2 ** -7, rtol=0)


def test_wrappers_launch_or_raise_off_the_cpu():
    """No plain version for a tensor that is not on the CPU: the meta device
    reaches the kernel path's checks and raises, as does unsupported geometry.
    ``use_flash=True`` routes to K11, which raises off the card too; an
    explicit mask, a cross-length call and a long call with the flash switch
    off take the plain route, which runs wherever the tensors lie."""
    x = torch.empty(2, 50, 2 * HD, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        at.short_attention_packed(x, x, x, num_heads=2)
    with pytest.raises(ValueError, match="CUDA"):
        at.short_attention(x[..., :HD], x[..., :HD], x[..., :HD])
    with pytest.raises(ValueError, match="head dim"):
        at.short_attention_packed(x, x, x, num_heads=4)
    long = torch.empty(1, at.SHORT_MAX_T + 1, HD, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="T <="):
        at.short_attention(long, long, long)
    with pytest.raises(ValueError, match="CUDA"):
        at.flash_attention(long, long, long, causal=True)
    with pytest.raises(ValueError, match="CUDA"):    # use_flash=True picks K11
        at.multi_head_attention(long, long, long, num_heads=1, use_flash=True)
    # the plain route: the flash switch off, an explicit mask, a shifted query block
    assert at.multi_head_attention(long, long, long, num_heads=1).shape == long.shape
    assert at.multi_head_attention(x, x, x, num_heads=2,
                                   mask=torch.zeros(50, 50, device="meta")).shape == x.shape
    assert at.multi_head_attention(x[:, :8], x, x, num_heads=2, causal=True,
                                   q_offset=42).shape == (2, 8, 2 * HD)
    # ... and on the CPU it computes mha_reference with the folded bias
    q, k, v = (torch.from_numpy(a) for a in _qkv(11, (2, 12, 2 * HD)))
    mask = torch.from_numpy(np.random.default_rng(12).standard_normal((5, 12)).astype(np.float32))

    def split(a):
        return a.reshape(2, -1, 2, HD).transpose(1, 2)

    got = at.multi_head_attention(q[:, :5], k, v, num_heads=2, mask=mask, causal=True, q_offset=7)
    want = at.mha_reference(split(q[:, :5]), split(k), split(v),
                            mask=mask + at._causal_bias(5, 12, 7))
    assert torch.equal(got, want.transpose(1, 2).reshape(2, 5, 2 * HD))
    assert (at.short_attention_packed.launches == 0 and at.short_attention.launches == 0
            and at.flash_attention.launches == 0)


def test_limits_match_the_jax_package():
    from summer_clip_tpu.ops import attention as jat

    assert at.SHORT_MAX_T == jat.SHORT_MAX_T == 640
    assert at.SHORT_MAX_T >= 577     # ViT-L/14@336px


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


# bf16 kernel vs bf16 plain version: same rounding points, other f32 summation
# orders; a probability may round to the neighbouring bf16 value, which moves an
# output of size ~1 by a few bf16 ulps (2^-8 each at [0.5, 1)).
CUDA_TOL = 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("t,causal,fused_qkv", [(50, False, True), (77, True, True),
                                                (257, False, False), (577, False, True),
                                                (1, True, False), (640, True, True)])
def test_cuda_k4_matches_plain(t, causal, fused_qkv):
    _cuda()
    gen = torch.Generator().manual_seed(t)
    heads, d = 3, 3 * HD
    qkv = torch.randn(2, t, 3 * d, generator=gen).to("cuda", torch.bfloat16)
    q, k, v = qkv.split(d, dim=-1)           # strided views of one projection
    if not fused_qkv:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    before = at.short_attention_packed.launches
    got = at.short_attention_packed(q, k, v, num_heads=heads, causal=causal)
    torch.cuda.synchronize()
    want = at.short_attention_packed_reference(q, k, v, num_heads=heads, causal=causal)
    assert at.short_attention_packed.launches == before + 1
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    assert float((got.float() - want.float()).abs().max()) < CUDA_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("t,causal", [(33, True), (257, False)])
def test_cuda_k12_matches_plain_and_k4(t, causal):
    _cuda()
    gen = torch.Generator().manual_seed(t)
    q, k, v = (torch.randn(6, t, HD, generator=gen).to("cuda", torch.bfloat16) for _ in range(3))
    got = at.short_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    mask = at._causal_bias(t, t, device="cuda") if causal else None
    want = at.mha_reference(q, k, v, mask=mask)
    assert float((got.float() - want.float()).abs().max()) < CUDA_TOL

    def pack(x):                              # (6, t, 64) -> (2, t, 3 * 64)
        return x.reshape(2, 3, t, HD).transpose(1, 2).reshape(2, t, 3 * HD)

    packed = at.short_attention_packed(pack(q), pack(k), pack(v), num_heads=3, causal=causal)
    assert torch.equal(pack(got), packed)     # the same device code


@pytest.mark.cuda
def test_cuda_kernel_refuses_grad_and_other_dtypes():
    _cuda()
    x = torch.randn(1, 8, HD, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="backward"):
        at.short_attention(x.requires_grad_(), x, x)
    with pytest.raises(TypeError, match="bfloat16"):
        at.short_attention(x.detach().half(), x.detach().half(), x.detach().half())
    with pytest.raises(TypeError, match="one type"):
        at.short_attention(x.detach(), x.detach().float(), x.detach())


@pytest.mark.cuda
@pytest.mark.parametrize("t,causal,fused_qkv", [(50, False, True), (77, True, True),
                                                (257, False, False), (640, True, True)])
def test_cuda_k4_f32_matches_plain(t, causal, fused_qkv):
    """f32 operands: true f32 products, so only the order of the sums differs."""
    _cuda()
    gen = torch.Generator().manual_seed(t)
    heads, d = 3, 3 * HD
    qkv = torch.randn(2, t, 3 * d, generator=gen).to("cuda")
    q, k, v = qkv.split(d, dim=-1)           # strided views of one projection
    if not fused_qkv:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    before = at.short_attention_packed.launches
    got = at.multi_head_attention(q, k, v, num_heads=heads, causal=causal)   # the rule picks K4
    torch.cuda.synchronize()
    assert at.short_attention_packed.launches == before + 1
    want = at.short_attention_packed_reference(q, k, v, num_heads=heads, causal=causal)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert float((got - want).abs().max()) < 2e-5
    one = at.short_attention(q[..., :HD].contiguous(), k[..., :HD].contiguous(),
                             v[..., :HD].contiguous(), causal=causal)        # K12, head 0
    assert torch.equal(one, got[..., :HD])


# T at the edges of the kernels' 64-row tiles and 16-key steps, up to SHORT_MAX_T
EDGE_T = (1, 15, 16, 17, 63, 64, 65, 77, 128, 150, 257, 320, 577, 640)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", EDGE_T)
def test_cuda_k4_and_k12_at_tile_edges(t, causal, dtype):
    """K4 on strided views of one fused (B, T, 3D) projection and K12 on (BH, T,
    64), BH = 3 x 5 heads (a multiple of no tile), against their plain versions
    at chip_smoke.py's limits: bf16 max 0.05 and mean 1e-3, f32 2e-5."""
    _cuda()
    dt = getattr(torch, dtype)
    tol_max, tol_mean = (0.05, 1e-3) if dt == torch.bfloat16 else (2e-5, 2e-5)
    gen = torch.Generator().manual_seed(1000 + t)
    b, heads = 3, 5
    d = heads * HD
    q, k, v = torch.randn(b, t, 3 * d, generator=gen).to("cuda", dt).split(d, dim=-1)
    got = at.short_attention_packed(q, k, v, num_heads=heads, causal=causal)
    want = at.short_attention_packed_reference(q, k, v, num_heads=heads, causal=causal)

    def split(x):
        return x.reshape(b, t, heads, HD).transpose(1, 2).reshape(b * heads, t, HD).contiguous()

    got12 = at.short_attention(split(q), split(k), split(v), causal=causal)
    torch.cuda.synchronize()
    for out, ref in ((got, want), (got12, split(want))):
        assert out.shape == ref.shape and torch.isfinite(out.float()).all()
        diff = (out.float() - ref.float()).abs()
        assert float(diff.max()) <= tol_max and float(diff.mean()) <= tol_mean, (
            float(diff.max()), float(diff.mean()))
    assert torch.equal(split(got), got12)     # one device code for both layouts
