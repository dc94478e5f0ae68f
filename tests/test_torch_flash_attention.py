"""K11 (flash attention) and the routing rule of ``multi_head_attention``,
against the JAX package.

The JAX side runs ``flash_attention`` in Pallas interpret mode; the port runs
its wrapper on CPU tensors, i.e. the plain version (``mha_reference`` with the
causal mask of a query block at ``q_offset`` folded into one bias). Same numpy
inputs. In f32 both compute f32 scores, an exact softmax (online on the JAX
side) and an f32 PV product: 2e-5, sums in another order. In bf16 both round
the probabilities to bf16 before the PV product and the output to bf16: 2e-2
(a few bf16 ulps of an output of size ~1). The ``cuda`` tests compare the CUDA
kernel with the plain version on a card and skip without one.
"""

import numpy as np
import pytest
import torch

from summer_clip_torch.ops import attention as at

HD = 64
CASES = [
    # bh, tq, tk, causal, q_offset
    (3, 40, 40, False, 0),
    (3, 40, 40, True, 0),
    (2, 130, 130, True, 0),         # more than one key tile of either kernel
    (2, 16, 48, True, 32),          # chunked prefill: a late query chunk over the whole history
    (2, 8, 40, False, 0),           # tq != tk
    (1, 1, 33, True, 32),           # one decode row
]


def _qkv(seed, bh, tq, tk):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bh, tq, HD)).astype(np.float32),
            rng.standard_normal((bh, tk, HD)).astype(np.float32),
            rng.standard_normal((bh, tk, HD)).astype(np.float32))


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("bh,tq,tk,causal,q_offset", CASES)
def test_plain_version_matches_jax_flash_kernel(bh, tq, tk, causal, q_offset, dtype, tol):
    import jax.numpy as jnp

    from summer_clip_tpu.ops import attention as jat

    q, k, v = _qkv(tq + tk, bh, tq, tk)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jat.flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)), causal=causal,
                               q_offset=q_offset, interpret=True)
    tq_, tk_, tv_ = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    for fn in (at.flash_attention_reference, at.flash_attention):   # the CPU wrapper is the plain version
        got = fn(tq_, tk_, tv_, causal=causal, q_offset=q_offset)
        assert got.dtype == tdt and tuple(got.shape) == (bh, tq, HD)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   rtol=tol, atol=tol)
    assert at.flash_attention.launches == 0


def test_plain_version_sees_keys_up_to_q_offset_plus_row():
    """Row i of a causal query block at ``q_offset`` ignores every key past
    ``q_offset + i``: changing those keys changes nothing."""
    q, k, v = map(torch.from_numpy, _qkv(1, 2, 4, 12))
    base = at.flash_attention_reference(q, k, v, causal=True, q_offset=5)
    k2, v2 = k.clone(), v.clone()
    k2[:, 6:], v2[:, 6:] = 9.0, -9.0            # row 0 sees keys 0..5
    moved = at.flash_attention_reference(q, k2, v2, causal=True, q_offset=5)
    assert torch.equal(moved[:, 0], base[:, 0]) and not torch.equal(moved[:, 3], base[:, 3])


ROUTE_CASES = [
    # dtype, tq, tk, has_mask, q_offset, use_flash
    ("bfloat16", 77, 77, False, 0, None),
    ("float32", 77, 77, False, 0, None),
    ("bfloat16", 77, 77, True, 0, None),
    ("bfloat16", 640, 640, False, 0, None),
    ("bfloat16", 641, 641, False, 0, None),
    ("float32", 1024, 1024, False, 0, None),
    ("float32", 1023, 1023, False, 0, None),
    ("float32", 1024, 1024, True, 0, None),
    ("float32", 1, 1024, False, 0, None),
    ("float32", 128, 1024, False, 896, None),
    ("bfloat16", 16, 77, False, 0, None),
    ("bfloat16", 77, 77, False, 3, None),
    ("bfloat16", 77, 77, False, 0, True),
    ("float32", 8, 8, False, 0, True),
    ("float32", 8, 8, True, 0, True),
    ("float32", 2048, 2048, False, 0, False),
    ("bfloat16", 77, 77, False, 0, False),
]


@pytest.mark.parametrize("flash_enabled", [False, True])
@pytest.mark.parametrize("on_card", [False, True])
@pytest.mark.parametrize("dtype,tq,tk,has_mask,q_offset,use_flash", ROUTE_CASES)
def test_routing_table_equals_the_jax_rule(monkeypatch, dtype, tq, tk, has_mask, q_offset,
                                           use_flash, on_card, flash_enabled):
    """``attention_route`` against what ``summer_clip_tpu``'s
    ``multi_head_attention`` really calls, with "on the TPU" standing for "on
    the card"."""
    import jax
    import jax.numpy as jnp

    from summer_clip_tpu.ops import attention as jat

    taken = []

    def stub(name):
        def fn(q, *a, **kw):
            taken.append(name)
            return jnp.zeros(q.shape, q.dtype)
        return fn

    monkeypatch.setattr(jat, "short_attention_packed_ad", stub("short_packed"))
    monkeypatch.setattr(jat, "flash_attention_ad", stub("flash"))
    monkeypatch.setattr(jat, "mha_reference", stub("plain"))
    monkeypatch.setattr(jat, "FLASH_ENABLED", flash_enabled)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu" if on_card else "cpu")
    jdt = getattr(jnp, dtype)
    q = jnp.zeros((1, tq, 2 * HD), jdt)
    kv = jnp.zeros((1, tk, 2 * HD), jdt)
    mask = jnp.zeros((tq, tk), jnp.float32) if has_mask else None
    jat.multi_head_attention(q, kv, kv, num_heads=2, mask=mask, causal=True, use_flash=use_flash,
                             q_offset=q_offset)
    want, = taken

    monkeypatch.setattr(at, "FLASH_ENABLED", flash_enabled)
    got = at.attention_route(on_card=on_card, tq=tq, tk=tk, has_mask=has_mask, q_offset=q_offset,
                             use_flash=use_flash)
    assert got == want
    assert at.FLASH_MIN_KV == jat.FLASH_MIN_KV and at.FLASH_ENABLED == jat.FLASH_ENABLED


def test_flash_switch_defaults_equal_the_jax_packages():
    from summer_clip_tpu.ops import attention as jat

    assert at.FLASH_ENABLED is False and jat.FLASH_ENABLED is False
    assert at.FLASH_MIN_KV == jat.FLASH_MIN_KV == 1024


@pytest.mark.parametrize("use_flash", [None, True, False])
def test_multi_head_attention_routes_compute_the_same_on_the_cpu(use_flash):
    """On the CPU every route ends in the plain version: ``use_flash=True``
    (K11's wrapper) and the default give what the JAX package gives."""
    import jax.numpy as jnp

    from summer_clip_tpu.ops import attention as jat

    rng = np.random.default_rng(21)
    q = rng.standard_normal((2, 6, 2 * HD)).astype(np.float32)
    k, v = (rng.standard_normal((2, 14, 2 * HD)).astype(np.float32) for _ in range(2))
    want = jat.multi_head_attention(*map(jnp.asarray, (q, k, v)), num_heads=2, causal=True,
                                    q_offset=8, use_flash=use_flash)
    got = at.multi_head_attention(*map(torch.from_numpy, (q, k, v)), num_heads=2, causal=True,
                                  q_offset=8, use_flash=use_flash)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 0.05)])
@pytest.mark.parametrize("bh,tq,tk,causal,q_offset", CASES + [(4, 1024, 1024, True, 0),
                                                              (4, 577, 577, False, 0),
                                                              (4, 128, 1024, True, 896)])
def test_cuda_k11_matches_plain(bh, tq, tk, causal, q_offset, dtype, tol):
    _cuda()
    q, k, v = (torch.from_numpy(x).to("cuda", dtype) for x in _qkv(tq + tk, bh, tq, tk))
    before = at.flash_attention.launches
    got = at.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert at.flash_attention.launches == before + 1
    want = at.flash_attention_reference(q, k, v, causal=causal, q_offset=q_offset)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    assert float((got.float() - want.float()).abs().max()) < tol


@pytest.mark.cuda
def test_cuda_multi_head_attention_takes_every_route():
    """Masked, cross-length and long calls run on the card: K11 where
    ``use_flash`` says so, the plain route elsewhere, K4 as before; an input
    that requires grad goes through ``flash_attention_ad`` and gets the plain
    route's gradient."""
    _cuda()
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 700, 2 * HD, generator=gen).to("cuda", torch.bfloat16)
    counts = lambda: (at.short_attention_packed.launches, at.flash_attention.launches)  # noqa: E731
    k4, k11 = counts()
    plain = at.multi_head_attention(q, q, q, num_heads=2, causal=True)                  # T > 640
    assert counts() == (k4, k11)
    flash = at.multi_head_attention(q, q, q, num_heads=2, causal=True, use_flash=True)
    assert counts() == (k4, k11 + 1)
    assert float((plain.float() - flash.float()).abs().max()) < 0.05
    mask = torch.zeros(700, 700, device="cuda")
    assert at.multi_head_attention(q, q, q, num_heads=2, mask=mask, use_flash=True).shape == q.shape
    assert counts() == (k4, k11 + 1)                                                    # a mask: plain
    at.multi_head_attention(q[:, :77], q[:, :77], q[:, :77], num_heads=2)
    assert counts() == (k4 + 1, k11 + 1)
    x = q[:, :8].float().requires_grad_()
    at.multi_head_attention(x, x, x, num_heads=2, use_flash=True).sum().backward()
    assert counts() == (k4 + 1, k11 + 2)
    y = x.detach().clone().requires_grad_()
    at.multi_head_attention(y, y, y, num_heads=2, use_flash=False).sum().backward()
    assert torch.allclose(x.grad, y.grad, rtol=1e-5, atol=1e-5)


def _edge_cases():
    """(tq, tk, q_offset) at the edges of the kernels' 64-row tiles: tq == tk,
    a late query chunk at q_offset = tk - tq, a short one at 896 and one that
    starts at 0 of a longer history."""
    cases = [(t, t, 0) for t in (1, 15, 16, 17, 63, 64, 65, 77, 128, 257, 577, 640)]
    for tq, tk in ((1, 65), (15, 77), (17, 128), (65, 257), (77, 577), (128, 1024), (63, 640)):
        cases += [(tq, tk, tk - tq), (tq, tk, 0)]
    cases += [(128, 1024, 896), (65, 1024, 896), (1, 1024, 896)]
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk,q_offset", _edge_cases())
def test_cuda_k11_at_tile_edges(tq, tk, q_offset, causal, dtype):
    """K11 against its plain version at chip_smoke.py's limits (bf16 max 0.05
    and mean 1e-3, f32 2e-5), BH = 7 (a multiple of no tile)."""
    _cuda()
    dt = getattr(torch, dtype)
    tol_max, tol_mean = (0.05, 1e-3) if dt == torch.bfloat16 else (2e-5, 2e-5)
    q, k, v = (torch.from_numpy(x).to("cuda", dt) for x in _qkv(tq * 7 + tk, 7, tq, tk))
    got = at.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    want = at.flash_attention_reference(q, k, v, causal=causal, q_offset=q_offset)
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    diff = (got.float() - want.float()).abs()
    assert float(diff.max()) <= tol_max and float(diff.mean()) <= tol_mean, (
        float(diff.max()), float(diff.mean()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_k11_takes_more_than_65535_heads(dtype):
    """The grid counts (query block, head) on x: no limit on BH."""
    _cuda()
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(70001, 2, HD, generator=gen).to("cuda", dt) for _ in range(3))
    got = at.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = at.flash_attention_reference(q, k, v, causal=True)
    assert float((got.float() - want.float()).abs().max()) <= (0.05 if dt == torch.bfloat16
                                                              else 2e-5)
