"""K1 (dense cache attention) of the port against the JAX kernel.

The JAX side runs ``cache_attention(..., interpret=True)`` (f32 compute on the
CPU) and ``cache_attention_reference``; the port runs its wrapper on CPU
tensors, i.e. the plain version. Same numpy inputs; f32 sums of the same terms
in another order hold to 1e-5 relative to the row sums (<= 60 here). The
``cuda`` tests compare the CUDA kernel with the plain version at its bf16
rounding points on a card and skip without one.
"""

import numpy as np
import pytest
import torch

from summer_clip_torch.ops import cache_kernels as ck

NT, NC, D, C = 20, 45, 32, 7


def _unit(rng, n, d=D):
    a = rng.standard_normal((n, d)).astype(np.float32)
    return a / np.linalg.norm(a, axis=1, keepdims=True)


def _problem(seed, values):
    rng = np.random.default_rng(seed)
    f, keys = _unit(rng, NT), _unit(rng, NC)
    outs = rng.standard_normal((NC, C)).astype(np.float32)
    if values == "softmax":
        e = np.exp(3 * outs - (3 * outs).max(1, keepdims=True))
        v = (e / e.sum(1, keepdims=True)).astype(np.float32)
    else:
        v = np.zeros((NC, C), np.int8)
        v[np.arange(NC), outs.argmax(1)] = 1
    betas = np.asarray([0.1, 1.0, 5.5, 11.5], np.float32)
    return f, keys, v, betas


@pytest.mark.parametrize("values", ["softmax", "int8_onehot"])
def test_dense_matches_jax_kernel_and_reference(values):
    import jax.numpy as jnp

    from summer_clip_tpu.ops import cache_kernels as jck

    f, keys, v, betas = _problem(1, values)
    got = ck.cache_attention(torch.from_numpy(f), torch.from_numpy(keys), torch.from_numpy(v),
                             torch.from_numpy(betas)).numpy()
    args = (jnp.asarray(f), jnp.asarray(keys), jnp.asarray(v), jnp.asarray(betas))
    want_kernel = np.asarray(jck.cache_attention(*args, interpret=True))
    want_ref = np.asarray(jck.cache_attention_reference(*args))
    assert got.shape == (4, NT, C)
    np.testing.assert_allclose(got, want_kernel, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=1e-5)


def test_auto_routes_values_to_dense_and_labels_to_label_kernels():
    f, keys, v, betas = _problem(2, "int8_onehot")
    tf, tk, tv, tb = map(torch.from_numpy, (f, keys, v, betas))
    dense = ck.cache_attention_auto(tf, tk, tv, tb)
    by_labels = ck.cache_attention_auto(tf, tk, tv, tb, cache_labels=v.argmax(1))
    np.testing.assert_allclose(dense.numpy(), ck.cache_attention_reference(tf, tk, tv, tb).numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dense.numpy(), by_labels.numpy(), rtol=1e-5, atol=1e-5)


def test_plain_version_rounding_points():
    """With compute_dtype=bf16 the plain version rounds features, floating
    values and weights to bf16 and keeps int8 values exact: it equals the f32
    oracle run on pre-rounded inputs up to the weight rounding (2^-9 relative
    per weight, <= NC weights per sum)."""
    f, keys, v, betas = _problem(3, "softmax")
    tf, tk, tv, tb = map(torch.from_numpy, (f, keys, v, betas))
    bf = torch.bfloat16
    got = ck.cache_attention_dense_reference(tf, tk, tv, tb, compute_dtype=bf)
    oracle = ck.cache_attention_reference(tf.to(bf), tk.to(bf), tv.to(bf), tb)
    assert float((got - oracle).abs().max()) <= NC * 2 ** -9
    assert float((got - oracle).abs().max()) > 0           # the weights were rounded
    v8 = torch.from_numpy(_problem(3, "int8_onehot")[2])
    same = ck.cache_attention_dense_reference(tf, tk, v8, tb)
    torch.testing.assert_close(same, ck.cache_attention_reference(tf, tk, v8, tb),
                               rtol=1e-5, atol=1e-5)


def test_dense_wrapper_launches_or_raises_off_the_cpu():
    meta = torch.empty(3, D, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ck.cache_attention(meta, torch.empty(4, D, device="meta"),
                           torch.empty(4, C, device="meta"), [1.0])
    with pytest.raises(ValueError, match="rows"):
        ck.cache_attention(meta, torch.empty(4, D, device="meta"),
                           torch.empty(5, C, device="meta"), [1.0])
    assert ck.cache_attention.launches == 0


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


# Sums of <= 700 terms <= 1: a weight may round to the neighbouring bf16 value
# when the plain f32 affinity differs in its last bit (2^-9 relative each).
CUDA_TOL = 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("nt,nc,d,c,nb", [(50, 300, 32, 7, 3), (70, 700, 512, 397, 11),
                                          (33, 129, 1024, 1000, 8)])
def test_cuda_k1_matches_plain(nt, nc, d, c, nb):
    """Ragged Nt, Nc and C, D below and above one 128-column slice, more betas
    than one launch takes; bf16 softmax values and int8 one-hots, the latter
    also against K2 on the same labels (the same bf16 weights: f32 order only)."""
    _cuda()
    rng = np.random.default_rng(nc)
    f = torch.from_numpy(_unit(rng, nt, d)).cuda()
    keys = torch.from_numpy(_unit(rng, nc, d)).cuda()
    outs = torch.from_numpy(rng.standard_normal((nc, c)).astype(np.float32)).cuda()
    labels = outs.argmax(1)
    betas = torch.linspace(0.1, 11.5, nb).cuda()
    soft = torch.softmax(5 * outs, 1).to(torch.bfloat16)
    hard = torch.nn.functional.one_hot(labels, c).to(torch.int8)
    before = ck.cache_attention.launches
    for v in (soft, hard):
        got = ck.cache_attention(f, keys, v, betas)
        torch.cuda.synchronize()
        want = ck.cache_attention_dense_reference(f, keys, v, betas, compute_dtype=torch.bfloat16)
        assert got.shape == (nb, nt, c) and torch.isfinite(got).all()
        assert float((got - want).abs().max()) < CUDA_TOL
    assert ck.cache_attention.launches == before + 2 * -(-nb // ck.K1_MAX_BETA)
    k2 = ck.cache_attention_labels(f, keys, labels.cpu().numpy(), betas, c)
    assert float((got - k2).abs().max()) < 1e-4
