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
                                          (33, 129, 1024, 1000, 8), (20, 100, 1152, 50, 8),
                                          (7, 200, 1024, 397, 3), (13, 1000, 768, 7, 11)])
def test_cuda_k1_matches_plain(nt, nc, d, c, nb):
    """Nt below and above one 16-query block, Nc not a multiple of the
    128-row step, C below, between and above 256-class slices, D from one
    64-column box to K1_MAX_D (1152: the shortest ring, 6 stages int8), more
    betas than one launch takes; bf16 softmax values and int8 one-hots, the
    latter also against K2 on the same labels (the same bf16 weights: f32
    order only)."""
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


@pytest.mark.cuda
def test_cuda_k1_affinity_is_k2s_bit_for_bit():
    """K1's transposed wgmma affinity and the class-grouped template's against
    K2's WMMA tiles on the same bf16 rows (``affinity_probe_bf16``: 8 tiles of
    64 queries x 128 cache rows): equal in every bit at widths of 1, 4, 12, 16
    and 64 sixteen-deep steps."""
    _cuda()
    from summer_clip_torch.ops import _lib

    gen = torch.Generator(device="cuda").manual_seed(3)
    lib = ck._lib_cache()
    for d in (16, 64, 192, 256, 1024):
        f = torch.randn(8 * 64, d, device="cuda", generator=gen)
        c = torch.randn(8 * 128, d, device="cuda", generator=gen)
        f = (f / f.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        c = (c / c.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        out = torch.zeros(3, 8, 64, 128, device="cuda")
        _lib.check(lib.affinity_probe_bf16(f.data_ptr(), c.data_ptr(), out.data_ptr(), d, 8,
                                           _lib.torch_stream()), "affinity_probe")
        torch.cuda.synchronize()
        assert torch.equal(out[0], out[1]) and torch.equal(out[0], out[2])
        assert torch.allclose(out[0, 0], f[:64].float() @ c[:128].float().t(), atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 512, 768, 1024, 1152])
def test_cuda_k1_ring_matches_the_host_plan(d):
    _cuda()
    lib = ck._lib_cache()
    for int8_values in (False, True):
        assert lib.cache_dense_feature_stages(d, int(int8_values)) == ck.k1_feature_stages(
            d, int8_values)


@pytest.mark.parametrize("d,bf16_stages,int8_stages", [(16, 12, 10), (768, 12, 8),
                                                       (1024, 12, 8), (1152, 10, 6)])
def test_k1_feature_ring_fits_shared_memory(d, bf16_stages, int8_stages):
    """The ring takes what the query boxes, value tiles and weight buffers
    leave of the 227 KB a block may use, at most 12 stages and an even number
    (a stage serves one of the two warpgroups)."""
    for int8_values, want in ((False, bf16_stages), (True, int8_stages)):
        stages = ck.k1_feature_stages(d, int8_values)
        assert stages == want and stages % 2 == 0
        assert ck.k1_shared_bytes(d, int8_values, stages) <= 232448
        if stages < 12:
            assert ck.k1_shared_bytes(d, int8_values, stages + 2) > 232448
    assert ck.k1_feature_stages(ck.K1_MAX_D, True) >= 4
    assert ck.k1_feature_stages(4096, True) == 0          # too wide for the resident queries


def test_k1_shared_memory_counts_each_buffer():
    # 768 wide: 12 query boxes of 2 KB, two bf16 value tiles of 32 KB, two w
    # buffers of 16 KB, 19 barriers, 1 KB of alignment
    assert ck.k1_shared_bytes(768, False, 0) == 12 * 2048 + 2 * 32768 + 2 * 16384 + 19 * 8 + 1024
    # int8: the raw tiles are half as large, plus a 32 KB bf16 conversion a warpgroup
    assert (ck.k1_shared_bytes(768, True, 0) - ck.k1_shared_bytes(768, False, 0)
            == -32768 + 2 * 32768)


@pytest.mark.parametrize("nt,c,want", [(8192, 1000, (512, 4)), (1000, 1000, (63, 4)),
                                       (7, 7, (1, 1)), (16, 256, (1, 1)), (17, 257, (2, 2))])
def test_k1_grid(nt, c, want):
    """16-query blocks by 256-class slices, ragged edges rounded up."""
    assert ck.k1_grid(nt, c) == want
