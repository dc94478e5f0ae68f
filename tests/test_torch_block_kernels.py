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
                                        (False, 5, 512), (True, bk.MAX_T, 512)])
def test_cuda_kernels_match_plain(cuda, causal, t, d):
    """Both K6 row tiles (48 rows at D=768, 32 at D=512), ragged last tiles,
    and K5 at the longest sequence its shared memory holds."""
    rng = np.random.default_rng(4)
    pa, pm = _attn_inputs(rng, d), _mlp_inputs(rng, d)
    x = torch.from_numpy(rng.standard_normal((3, t, d)).astype(np.float32)).to(cuda, torch.bfloat16)
    attn = [a.to(cuda) for a in _port_attn_args(pa, torch.bfloat16)]
    mlp = [a.to(cuda) for a in _port_mlp_args(pm, torch.bfloat16)]
    for kern, plain, args, kw in (
            (bk.fused_ln_attn, bk.ln_attn_reference, attn, dict(num_heads=d // 64, causal=causal)),
            (bk.fused_ln_mlp, bk.ln_mlp_reference, mlp, {})):
        got = kern(x, *args, **kw).float()
        want = plain(x, *args, **kw).float()
        torch.cuda.synchronize()
        assert (got - want).abs().max() <= 0.0625
        assert (got - want).abs().mean() <= 2e-3
