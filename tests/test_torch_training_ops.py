"""The training side of the port's kernels against the JAX package: K9
``fused_ln_mlp_chunked``'s plain version, and the gradients of every ``_ad``
wrapper (the kernel forward, the plain version recomputed for the backward).

The JAX side runs its Pallas kernels in interpret mode on the CPU and takes
``jax.grad`` of its own ``_ad`` wrappers (Pallas forward, XLA recompute
backward). The port runs its wrappers on CPU tensors, i.e. the plain
versions, and, through :func:`recompute_backward` directly, the
autograd.Function that the card uses (its "kernel" being the CPU wrapper).
Same numpy inputs in f32. Forwards agree to 5e-5 and gradients to 5e-4 (the
JAX package's own tolerances, ``tests/test_ops.py``). The ``cuda`` tests hold
K9 against its plain version on a card, and the gradient through a text tower
on the kernel route against the plain route; they skip without a card.
"""

import functools

import numpy as np
import pytest
import torch

from summer_clip_torch.ops import attention as at
from summer_clip_torch.ops import block_kernels as bk
from summer_clip_torch.ops.autograd import recompute_backward

GRAD_TOL = dict(rtol=5e-4, atol=5e-4)


def _mlp_np(seed, b, t, d):
    r = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (r.randn(*s) * scale).astype(np.float32)  # noqa: E731
    return dict(x=f(b, t, d), ln_w=1.0 + f(d, scale=0.1), ln_b=f(d, scale=0.1),
                w1=f(d, 4 * d, scale=d ** -0.5), b1=f(4 * d, scale=0.05),
                w2=f(4 * d, d, scale=(4 * d) ** -0.5), b2=f(d, scale=0.05))


def _mlp_jax(p):
    import jax.numpy as jnp

    return [jnp.asarray(p[k]) for k in ("x", "ln_w", "ln_b", "w1", "b1", "w2", "b2")]


def _mlp_port(p):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return [t(p["x"]), t(p["ln_w"]), t(p["ln_b"]), t(p["w1"].T), t(p["b1"]), t(p["w2"].T),
            t(p["b2"])]


def _attn_np(seed, b, t, d):
    r = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (r.randn(*s) * scale).astype(np.float32)  # noqa: E731
    p = dict(x=f(b, t, d), ln_w=1.0 + f(d, scale=0.1), ln_b=f(d, scale=0.1))
    for k in ("q", "k", "v", "o"):
        p["w" + k], p["b" + k] = f(d, d, scale=d ** -0.5), f(d, scale=0.05)
    return p


def _attn_jax(p):
    import jax.numpy as jnp

    return [jnp.asarray(p[k]) for k in
            ("x", "ln_w", "ln_b", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")]


def _attn_port(p):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    in_w = np.concatenate([p["wq"].T, p["wk"].T, p["wv"].T])
    return [t(p["x"]), t(p["ln_w"]), t(p["ln_b"]), t(in_w),
            t(np.concatenate([p["bq"], p["bk"], p["bv"]])), t(p["wo"].T), t(p["bo"])]


def _port_grads(fn, args, wrt):
    leaves = [a.clone().requires_grad_(i in wrt) for i, a in enumerate(args)]
    (fn(*leaves).float() ** 2).sum().backward()
    return [leaves[i].grad.numpy() for i in wrt]


@pytest.mark.parametrize("hc", [64, 128])
def test_k9_plain_version_matches_jax_chunked_kernel(hc):
    """K9's plain version (``ln_mlp_reference``, what the CPU wrapper runs)
    against the JAX hidden-chunked kernel with 4 or 2 hidden chunks."""
    from summer_clip_tpu.ops import block_kernels as jbk

    p = _mlp_np(4, 2, 50, 64)
    want = np.asarray(jbk.fused_ln_mlp_chunked(*_mlp_jax(p), interpret=True, hidden_chunk=hc))
    got = bk.fused_ln_mlp_chunked(*_mlp_port(p))
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-5, atol=5e-5)
    assert bk.fused_ln_mlp_chunked.launches == 0


@functools.lru_cache(maxsize=None)
def _jax_attn_grads():
    import jax
    import jax.numpy as jnp

    from summer_clip_tpu.ops import block_kernels as jbk

    jargs = _attn_jax(_attn_np(3, 2, 40, 64))
    return jax.grad(lambda x, wq: jnp.sum(jbk.fused_ln_attn_ad(
        x, *jargs[1:3], wq, *jargs[4:], 4, True) ** 2), argnums=(0, 1))(jargs[0], jargs[3])


@pytest.mark.parametrize("route", ["wrapper", "recompute"])
def test_ln_attn_ad_gradient_matches_jax(route):
    p = _attn_np(3, 2, 40, 64)
    gx, gw = _jax_attn_grads()
    kw = dict(num_heads=4, causal=True)
    fn = ((lambda *a: bk.fused_ln_attn_ad(*a, **kw)) if route == "wrapper" else
          (lambda *a: recompute_backward(bk.fused_ln_attn, bk.ln_attn_reference, a, kw)))
    got_x, got_in_w = _port_grads(fn, _attn_port(p), wrt=(0, 3))
    np.testing.assert_allclose(got_x, np.asarray(gx), **GRAD_TOL)
    # the port's in_proj_weight stacks W_q^T, W_k^T, W_v^T
    np.testing.assert_allclose(got_in_w[:64].T, np.asarray(gw), **GRAD_TOL)


@functools.lru_cache(maxsize=None)
def _jax_mlp_grad(arm):
    import jax
    import jax.numpy as jnp

    from summer_clip_tpu.ops import block_kernels as jbk

    jargs = _mlp_jax(_mlp_np(2, 2, 40, 64))
    limit = jbk.FUSED_MLP_MAX_WEIGHT_BYTES
    jbk.FUSED_MLP_MAX_WEIGHT_BYTES = 1024 if arm == "chunked" else limit
    try:
        return jax.grad(lambda x: jnp.sum(jbk.fused_ln_mlp_ad(x, *jargs[1:]) ** 2))(jargs[0])
    finally:
        jbk.FUSED_MLP_MAX_WEIGHT_BYTES = limit


@pytest.mark.parametrize("arm", ["resident", "chunked"])
@pytest.mark.parametrize("route", ["wrapper", "recompute"])
def test_ln_mlp_ad_gradient_matches_jax_on_both_dispatch_arms(arm, route, monkeypatch):
    """Both arms of the JAX package's ``_mlp_dispatch`` (K6, K9), chosen by
    the weight size as ``tests/test_ops.py`` does it, in both packages."""
    if arm == "chunked":
        monkeypatch.setattr(bk, "FUSED_MLP_MAX_WEIGHT_BYTES", 1024)
    p = _mlp_np(2, 2, 40, 64)
    want = _jax_mlp_grad(arm)
    args = _mlp_port(p)
    kern = bk.mlp_kernel(args[0], args[3])
    assert kern is (bk.fused_ln_mlp_chunked if arm == "chunked" else bk.fused_ln_mlp)
    fn = (bk.fused_ln_mlp_ad if route == "wrapper" else
          (lambda *a: recompute_backward(kern, bk.ln_mlp_reference, a)))
    got, = _port_grads(fn, args, wrt=(0,))
    np.testing.assert_allclose(got, np.asarray(want), **GRAD_TOL)


def _qkv(seed, shape):
    r = np.random.RandomState(seed)
    return [r.randn(*shape).astype(np.float32) for _ in range(3)]


@functools.lru_cache(maxsize=None)
def _jax_attention_grads(kind):
    import jax
    import jax.numpy as jnp

    from summer_clip_tpu.ops import attention as jat

    if kind == "packed":
        fn, qkv = (lambda *a: jat.short_attention_packed_ad(*a, 2, True)), _qkv(5, (2, 33, 128))
    elif kind == "short":
        fn, qkv = (lambda *a: jat.short_attention_ad(*a, False)), _qkv(6, (4, 29, 64))
    else:
        fn, qkv = (lambda *a: jat.flash_attention_ad(*a, True, 32)), _flash_qkv()
    return jax.grad(lambda *a: jnp.sum(fn(*a) ** 2), argnums=(0, 1, 2))(*map(jnp.asarray, qkv))


def _flash_qkv():
    r = np.random.RandomState(7)
    q = r.randn(2, 16, 64).astype(np.float32)
    k, v = (r.randn(2, 48, 64).astype(np.float32) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("route", ["wrapper", "recompute"])
def test_short_attention_packed_ad_gradient_matches_jax(route):
    q, k, v = _qkv(5, (2, 33, 128))
    want = _jax_attention_grads("packed")
    kw = dict(num_heads=2, causal=True)
    fn = ((lambda *a: at.short_attention_packed_ad(*a, **kw)) if route == "wrapper" else
          (lambda *a: recompute_backward(at.short_attention_packed,
                                         at.short_attention_packed_reference, a, kw)))
    got = _port_grads(fn, [torch.from_numpy(a) for a in (q, k, v)], wrt=(0, 1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("route", ["wrapper", "recompute"])
def test_short_attention_ad_gradient_matches_jax(route):
    q, k, v = _qkv(6, (4, 29, 64))
    want = _jax_attention_grads("short")
    fn = (at.short_attention_ad if route == "wrapper" else
          (lambda *a: recompute_backward(at.short_attention, at.short_attention_reference, a,
                                         {"causal": False})))
    got = _port_grads(fn, [torch.from_numpy(a) for a in (q, k, v)], wrt=(0, 1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("route", ["wrapper", "recompute"])
def test_flash_attention_ad_gradient_matches_jax(route):
    """A late query block (tq = 16 of tk = 48 at q_offset 32), causal."""
    q, k, v = _flash_qkv()
    want = _jax_attention_grads("flash")
    kw = dict(causal=True, q_offset=32)
    fn = ((lambda *a: at.flash_attention_ad(*a, **kw)) if route == "wrapper" else
          (lambda *a: recompute_backward(at.flash_attention, at.flash_attention_reference, a, kw)))
    got = _port_grads(fn, [torch.from_numpy(a) for a in (q, k, v)], wrt=(0, 1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL)


def test_recompute_saves_only_inputs_and_grads_only_what_is_asked():
    """The forward keeps no intermediate (only the inputs, as the JAX
    residuals) and the backward differentiates only the inputs that need it."""
    p = _mlp_np(8, 1, 9, 64)
    args = _mlp_port(p)
    x = args[0].clone().requires_grad_()
    out = recompute_backward(bk.fused_ln_mlp, bk.ln_mlp_reference, [x, *args[1:]])
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 7 and all(s.shape == a.shape for s, a in zip(saved, args))
    out.sum().backward()
    assert x.grad is not None and all(not a.requires_grad for a in args[1:])


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_raw_kernels_refuse_inputs_that_require_grad():
    """On a non-CPU tensor the raw K5 / K6 / K9 wrappers are forward-only: an
    input that requires grad raises before anything launches."""
    for d, kern in ((1024, bk.fused_ln_mlp_chunked), (768, bk.fused_ln_mlp)):
        ln = _meta(d, dtype=torch.float32)
        mlp = (ln, ln, _meta(4 * d, d), _meta(4 * d), _meta(d, 4 * d), _meta(d))
        with pytest.raises(NotImplementedError, match="_ad wrapper"):
            kern(_meta(2, 9, d).requires_grad_(), *mlp)
    ln = _meta(512, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="_ad wrapper"):
        bk.fused_ln_attn(_meta(2, 9, 512).requires_grad_(), ln, ln, _meta(1536, 512),
                         _meta(1536), _meta(512, 512), _meta(512), num_heads=8)
    with pytest.raises(ValueError, match="K9 kernel takes D"):
        bk.fused_ln_mlp_chunked(_meta(2, 9, 768), ln, ln, _meta(3072, 768), _meta(3072),
                                _meta(768, 3072), _meta(768))
    assert bk.fused_ln_mlp_chunked.launches == 0


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,t", [(3, 50), (2, 257), (1, 257), (32, 257)])
def test_cuda_k9_matches_plain_and_repeats_bit_for_bit(cuda, b, t):
    """Row counts that leave the last 64-row tile ragged (150, 514, 257) and
    the ViT-L/14 batch (8224 rows, 129 tiles): two runs give the same bits,
    and a sequence alone gives the bits it has among the others."""
    p = _mlp_np(9, b, t, 1024)
    args = [a.to(cuda, torch.float32 if i in (1, 2) else torch.bfloat16)   # LayerNorm in f32
            for i, a in enumerate(_mlp_port(p))]
    got = bk.fused_ln_mlp_chunked(*args)
    again = bk.fused_ln_mlp_chunked(*args)
    alone = bk.fused_ln_mlp_chunked(args[0][-1:].contiguous(), *args[1:])
    want = bk.ln_mlp_reference(*args)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    assert torch.equal(got, again) and torch.equal(alone[0], got[-1])
    assert diff.max() <= 0.125 and diff.mean() <= 2e-3


@pytest.mark.cuda
def test_cuda_k9_takes_a_hidden_of_half_a_chunk_more(cuda):
    """H = 1088 = 8.5 chunks of 128: the last chunk's missing hidden columns
    arrive as TMA's zeros and add nothing."""
    r = np.random.RandomState(10)
    d, h = 1024, 1088
    f = lambda *s, scale=1.0: torch.from_numpy((r.randn(*s) * scale).astype(np.float32))  # noqa: E731
    args = [f(2, 70, d).to(cuda, torch.bfloat16), (1.0 + f(d, scale=0.1)).to(cuda),
            f(d, scale=0.1).to(cuda), f(h, d, scale=d ** -0.5).to(cuda, torch.bfloat16),
            f(h, scale=0.05).to(cuda, torch.bfloat16),
            f(d, h, scale=h ** -0.5).to(cuda, torch.bfloat16), f(d, scale=0.05).to(cuda, torch.bfloat16)]
    got = bk.fused_ln_mlp_chunked(*args)
    want = bk.ln_mlp_reference(*args)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    assert diff.max() <= 0.125 and diff.mean() <= 2e-3


@pytest.mark.cuda
def test_cuda_k9_shared_memory_and_cluster_match_the_host_plan(cuda):
    lib = bk._lib_block()
    assert lib.ln_mlp_wide_smem_bytes() == bk.K9_SHARED_BYTES
    assert lib.ln_mlp_wide_cluster() == bk.K9_CLUSTER


@pytest.mark.parametrize("rows,hidden,want", [(8224, 4096, (258, 32)), (150, 4096, (6, 32)),
                                              (64, 4096, (2, 32)), (1, 1088, (2, 9))])
def test_k9_launch_plan(rows, hidden, want):
    """Two blocks (a cluster) a 64-row tile, the last tile ragged; the hidden
    in chunks of 128, a last half chunk counted whole."""
    assert bk.k9_grid(rows, hidden) == want


def test_k9_shared_memory_fits_a_block():
    """LN(x) of 64 rows (128 KB), five 16 KB weight stages, the 64 x 136
    hidden chunk and the barriers fit the 227 KB a block may use."""
    assert bk.K9_SHARED_BYTES == 1024 + 131072 + 5 * 16384 + 64 * 136 * 2 + 7 * 8
    assert bk.K9_SHARED_BYTES <= 232448
    assert bk.K9_SHARED_BYTES + 16384 > 232448          # a sixth stage would not fit


@pytest.mark.cuda
def test_cuda_gradient_through_the_text_tower_matches_the_plain_route(cuda, monkeypatch):
    """A prompt gradient through a ViT-B/16-width text tower (2 blocks, bf16)
    on the kernel route (K5 + K6 forwards, plain recompute backwards) is
    non-zero and within ``chip_smoke``'s gradient gate of the route that
    launches no kernel."""
    import chip_smoke
    from summer_clip_torch.models.clip import modeling

    torch.manual_seed(0)
    tower = modeling.Transformer(512, 2, 8)
    with torch.no_grad():
        for name, prm in tower.named_parameters():
            if prm.dim() == 2:
                prm.copy_(torch.randn(prm.shape) * prm.shape[1] ** -0.5)
            if "ln_" not in name:
                prm.data = prm.data.to(torch.bfloat16)
    tower = tower.requires_grad_(False).to(cuda)
    base = torch.randn(16, 77, 512, device=cuda).to(torch.bfloat16)
    prompt0 = torch.randn(4, 512, device=cuda) * 0.02

    def loss_and_grad():
        prompt = prompt0.clone().requires_grad_()
        x = torch.cat([base[:, :1], prompt.to(base.dtype)[None].expand(16, 4, 512),
                       base[:, 5:]], dim=1)
        loss = tower(x, True).float().pow(2).mean()
        loss.backward()
        return loss.item(), prompt.grad

    k5, k6 = bk.fused_ln_attn.launches, bk.fused_ln_mlp.launches
    loss_k, grad_k = loss_and_grad()
    assert (bk.fused_ln_attn.launches - k5, bk.fused_ln_mlp.launches - k6) == (2, 2)
    monkeypatch.setattr(modeling, "FUSED_BLOCK_MODE", "xla")
    monkeypatch.setattr(at, "SHORT_FUSED_ENABLED", False)
    loss_p, grad_p = loss_and_grad()
    assert float(grad_k.norm()) > 0
    rel = float((grad_k - grad_p).norm() / grad_p.norm())
    cos = float(torch.nn.functional.cosine_similarity(grad_k.flatten(), grad_p.flatten(), dim=0))
    print(f"text tower gradient, kernel vs plain route: loss_rel {abs(loss_k - loss_p) / abs(loss_p):.3e} "
          f"grad_rel {rel:.3e} grad_cos {cos:.7f}")
    assert abs(loss_k - loss_p) <= chip_smoke.TOL_GATE_LOSS * abs(loss_p)
    assert rel <= chip_smoke.TOL_GATE_GRAD_REL and cos >= chip_smoke.TOL_GATE_GRAD_COS
