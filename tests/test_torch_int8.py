"""The int8 CLIP towers (``clip.quant=int8``) of the port against the JAX
package's ``ops/int8.py`` and its quantized towers.

- ``quantize_rows`` / ``quantize_cols``: ``q`` and the scales bit for bit
  against the jitted JAX functions (under ``jit`` XLA divides by 127 as a
  product with the reciprocal, which the port does too);
- the int32 sums of ``int8_dense`` bit for bit against ``jax.lax.dot`` with
  ``preferred_element_type=int32``; the rescaled output equal in bf16, and
  within one f32 ulp in f32 (XLA contracts ``acc * xs * ws + bias`` into a
  fused multiply-add);
- ``int8_conv2d`` against JAX's NHWC ``QuantConv`` bit for bit, the 27-wide
  RN stem (3 x 3 x 3) included;
- the port's stacked q/k/v product against three separate products;
- an int8 ``test-vit`` session (f32 and bf16) and an RN50-width ResNet
  (width 64, one block a stage, 32 px) against the JAX package's jitted int8
  towers on the same weights: in f32 a cosine above 0.9998 and every feature
  within 2.5% of the largest |feature|, in bf16 above 0.9995 and within 3%.
  An int8 rounding that flips on an ulp moves a value by a whole quantization
  step (a per-tensor step, in the ResNet), so the JAX package parts from
  itself by as much: its RN50-width image tower with the weights as jit
  arguments against the same function with the weights folded as constants
  reads a cosine of 0.99990, and its bf16 test-vit towers jitted against
  eager read 0.99988 (image) and 0.99977 (text), max |d| 1.2% and 2.0%. The
  port against the jitted towers reads 0.999999 (f32) and 0.99990 / 0.99968,
  0.9% / 2.2% (bf16 image / text).
"""

import dataclasses

import numpy as np
import pytest
import torch

from summer_clip_torch.ops import int8 as P


def _jit(fn):
    import jax

    return jax.jit(fn)


@pytest.mark.parametrize("shape", [(50, 72), (3, 27), (1, 8)])
def test_quantize_rows_and_cols_equal_the_jitted_jax_functions(shape):
    from summer_clip_tpu.ops import int8 as J

    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x[0, :2] = 0.0
    for jf, pf in ((J.quantize_rows, P.quantize_rows), (J.quantize_cols, P.quantize_cols)):
        jq, js = _jit(jf)(x)
        pq, ps = pf(torch.from_numpy(x))
        assert pq.dtype == torch.int8 and ps.dtype == torch.float32
        np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ps.numpy().reshape(-1), np.asarray(js).reshape(-1))
    zero = np.zeros((2, 8), np.float32)            # the 1e-12 floor
    np.testing.assert_array_equal(P.quantize_rows(torch.from_numpy(zero))[1].numpy(),
                                  np.asarray(_jit(J.quantize_rows)(zero)[1]))


@pytest.mark.parametrize("with_bias", [True, False])
def test_int8_dense_sums_and_outputs_equal_jax(with_bias):
    import jax
    import jax.numpy as jnp

    from summer_clip_tpu.ops import int8 as J

    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 25, 72)) * 2).astype(np.float32)
    w = (rng.standard_normal((72, 40)) * 0.1).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32) if with_bias else None
    x8, _ = P.quantize_rows(torch.from_numpy(x.reshape(-1, 72)))
    w8, _ = P.quantize_cols(torch.from_numpy(w))
    want = _jit(lambda a, c: jax.lax.dot(a, c, preferred_element_type=jnp.int32))(
        jnp.asarray(x8.numpy()), jnp.asarray(w8.numpy()))
    got = P.int8_sums(x8, w8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        jy = np.asarray(_jit(lambda a, c, d: J.int8_dense(a, c, d, out_dtype=jdt))(x, w, b)
                        .astype(jnp.float32))
        py = P.int8_dense(torch.from_numpy(x), torch.from_numpy(w),
                          None if b is None else torch.from_numpy(b), tdt)
        assert py.dtype == tdt and py.shape == (2, 25, 40)
        if tdt == torch.bfloat16 or not with_bias:
            np.testing.assert_array_equal(py.float().numpy(), jy)
        else:
            # one f32 rounding of the product apart (XLA's fused multiply-add)
            np.testing.assert_allclose(py.numpy(), jy, rtol=2 ** -23,
                                       atol=2 ** -22 * float(np.abs(jy).max()))


@pytest.mark.parametrize("k,stride,pad,cin,cout", [(3, 2, 1, 3, 16),   # the RN stem: K = 27
                                                   (3, 1, 1, 16, 24), (1, 1, 0, 24, 32)])
def test_int8_conv_equals_jax_quantconv(k, stride, pad, cin, cout):
    import jax
    import jax.numpy as jnp

    from summer_clip_tpu.ops import int8 as J

    rng = np.random.default_rng(k + cin)
    x = rng.standard_normal((2, 9, 9, cin)).astype(np.float32)
    conv = J.QuantConv(cout, (k, k), strides=(stride, stride), padding=pad, quant="int8",
                       dtype=jnp.float32)
    variables = conv.init(jax.random.PRNGKey(k), x)
    want = np.asarray(_jit(conv.apply)(variables, x))
    kernel = torch.from_numpy(np.array(variables["params"]["kernel"]))      # HWIO
    got = P.int8_conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                        stride, pad, torch.float32)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_stacked_qkv_equals_three_products():
    """One int8 product of the stacked (3D, D) in_proj equals the JAX
    package's q_proj, k_proj and v_proj: each output column has its own
    scale, and the three share the rows' activation scale."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((3, 11, 32)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((96, 32)) * 0.2).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(96).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        stacked = P.int8_linear(x.to(dtype), w, b)
        parts = [P.int8_linear(x.to(dtype), w[i * 32:(i + 1) * 32], b[i * 32:(i + 1) * 32])
                 for i in range(3)]
        assert torch.equal(stacked, torch.cat(parts, dim=-1))


def test_unknown_quant_mode_raises():
    from summer_clip_torch.models.clip import build_clip

    with pytest.raises(ValueError, match="unknown quant mode"):
        build_clip("test-vit", quant="int4", device="cpu")


RN50_WIDTH = ("test-rn50w", 1024, 32, "resnet", 64, (1, 1, 1, 1), None, 16, 512, 64, 2, 1)


def _towers(name, monkeypatch, dtype):
    """An int8 port session of ``name`` (seed 3) and the JAX package's int8
    towers on the same weights (through both packages' OpenAI-layout
    converters), with jitted image and text encoders."""
    import jax
    import jax.numpy as jnp

    import summer_clip_tpu.models.clip.configs as jconfigs
    from summer_clip_tpu.models.clip import convert as jconvert

    from summer_clip_torch.apps.common import create_clip_session
    from summer_clip_torch.models.clip import (CLIP_CONFIGS, CLIPConfig, build_clip,
                                               to_openai_state_dict)

    if name == RN50_WIDTH[0]:
        monkeypatch.setitem(CLIP_CONFIGS, name, CLIPConfig(*RN50_WIDTH))
        monkeypatch.setitem(jconfigs.CLIP_CONFIGS, name, jconfigs.CLIPConfig(*RN50_WIDTH))
    session = create_clip_session(name, None, dtype, device="cpu", quant="int8", seed=3)
    ref, cfg = build_clip(name, torch.Generator().manual_seed(3), device="cpu")
    variables = jconvert.convert_state_dict({k: v.numpy() for k, v in to_openai_state_dict(ref).items()})
    model_j, _ = jconfigs.build_clip(name, dtype={"float32": jnp.float32,
                                                  "bfloat16": jnp.bfloat16}[dtype], quant="int8")

    def encoder(method):
        fn = jax.jit(lambda x: model_j.apply(variables, x, method=method))
        return lambda x: np.asarray(fn(jnp.asarray(x)).astype(jnp.float32))

    return encoder(model_j.encode_image), encoder(model_j.encode_text), session, cfg


@pytest.mark.parametrize("name,dtype", [("test-vit", "float32"), ("test-vit", "bfloat16"),
                                        (RN50_WIDTH[0], "float32")])
def test_int8_session_matches_the_jax_int8_towers(name, dtype, monkeypatch):
    encode_image, encode_text, session, cfg = _towers(name, monkeypatch, dtype)
    model = session.model
    blocks = [m for m in model.modules() if hasattr(m, "quant_params")]
    assert blocks and all(m.quant == "int8" for m in blocks)
    assert all(p.dtype == torch.float32 for m in blocks for p in m.quant_params())
    rng = np.random.default_rng(4)
    r = cfg.image_resolution
    images = rng.standard_normal((3, r, r, 3)).astype(np.float32)
    tokens = rng.integers(1, cfg.vocab_size - 2, (3, cfg.context_length)).astype(np.int32)
    tokens[:, 6] = cfg.vocab_size - 1
    want_img, want_txt = encode_image(images), encode_text(tokens)
    with torch.inference_mode():
        got_img = model.encode_image(torch.from_numpy(images)).float().numpy()
        got_txt = model.encode_text(torch.from_numpy(tokens).long()).float().numpy()
    for got, want in ((got_img, want_img), (got_txt, want_txt)):
        assert got.shape == want.shape and np.isfinite(got).all()
        max_d, min_cos = (0.025, 0.9998) if dtype == "float32" else (0.03, 0.9995)
        np.testing.assert_allclose(got, want, rtol=0, atol=max_d * np.abs(want).max())
        cos = (got * want).sum(-1) / np.linalg.norm(got, axis=-1) / np.linalg.norm(want, axis=-1)
        assert cos.min() > min_cos, cos


def test_int8_towers_keep_the_float_towers_weights():
    """``quant`` changes the products, not the weights: the same seed gives
    the same parameters, and features near the float tower's."""
    from summer_clip_torch.models.clip import build_clip

    ref, cfg = build_clip("test-vit", torch.Generator().manual_seed(5), device="cpu")
    q, _ = build_clip("test-vit", torch.Generator().manual_seed(5), device="cpu", quant="int8")
    for (n, a), (_, b) in zip(ref.named_parameters(), q.named_parameters()):
        assert torch.equal(a, b), n
    images = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, cfg.image_resolution, cfg.image_resolution, 3)).astype(np.float32))
    with torch.inference_mode():
        a, b = ref.encode_image(images), q.encode_image(images)
    assert not torch.equal(a, b)
    assert float(torch.nn.functional.cosine_similarity(a, b, dim=-1).min()) > 0.99


def test_dataclass_rn50_width_is_rn50s_width():
    from summer_clip_torch.models.clip import CLIP_CONFIGS, CLIPConfig

    cfg, rn50 = CLIPConfig(*RN50_WIDTH), CLIP_CONFIGS["RN50"]
    same = ("embed_dim", "vision_kind", "vision_width")
    assert all(getattr(cfg, f) == getattr(rn50, f) for f in same)
    assert cfg.vision_heads == rn50.vision_heads
    assert dataclasses.replace(cfg, name="RN50", image_resolution=224,
                               vision_layers=(3, 4, 6, 3)).vision_heads == 32
