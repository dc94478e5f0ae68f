"""The ModifiedResNet tower, the converter's ResNet half, and the per-half
block routes of the port against the JAX package.

The JAX package's ``init_clip`` variables (BatchNorm statistics perturbed, so
that they matter) go through ``from_flax_variables`` into the port's modules;
both encode the same numpy inputs on the CPU in f32 and agree to 1e-4
(summation order only). Two narrow ViT configs exist only here: an "L-shaped"
one (T = 257 > 240, D = 128) that must take the K4 route with the plain MLP, as
ViT-L/14's image tower does, and a "B-shaped" one (D = 512, T = 17) that must
take K5 + K6.
"""

import dataclasses

import numpy as np
import pytest
import torch

from summer_clip_torch.models.clip import (CLIP, CLIP_CONFIGS, CLIPConfig, build_clip,
                                           detect_model_name, from_flax_variables, load_clip,
                                           to_openai_state_dict)
from summer_clip_torch.ops import attention as at
from summer_clip_torch.ops import block_kernels as bk

SHAPES = {
    # name: (config, routes of the image tower's halves)
    # patch 1: T = 1025, past both packages' fused limit of 640 tokens
    "test-L": (CLIPConfig("test-L", 32, 32, "vit", 128, 2, 1, 16, 512, 128, 2, 1),
               ("k4", "plain_mlp")),
    # patch 2: T = 257, inside K5's limit since its attention is K4's code
    "test-M": (CLIPConfig("test-M", 32, 32, "vit", 128, 2, 2, 16, 512, 128, 2, 1),
               ("k5", "k6")),
    "test-B": (CLIPConfig("test-B", 32, 32, "vit", 512, 1, 8, 16, 512, 512, 8, 1),
               ("k5", "k6")),
}


def _jax_model(name, seed, perturb_stats=False):
    import jax

    from summer_clip_tpu.models.clip import init_clip

    model, cfg, variables = init_clip(name, jax.random.PRNGKey(seed))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    if perturb_stats:
        rng = np.random.default_rng(seed)
        variables = {"params": variables["params"], "batch_stats": jax.tree_util.tree_map(
            lambda x: (x + 0.2 * np.abs(rng.standard_normal(x.shape))).astype(np.float32),
            variables["batch_stats"])}
    return model, cfg, variables


def _inputs(cfg, seed=0, n=2):
    rng = np.random.default_rng(seed)
    r = cfg.image_resolution
    images = rng.standard_normal((n, r, r, 3)).astype(np.float32)
    tokens = rng.integers(1, cfg.vocab_size - 2, (n, cfg.context_length)).astype(np.int32)
    tokens[:, 5] = cfg.vocab_size - 1
    return images, tokens


def _encode_jax(model, variables, images, tokens):
    import jax.numpy as jnp

    img = model.apply(variables, jnp.asarray(images), method=model.encode_image)
    txt = model.apply(variables, jnp.asarray(tokens), method=model.encode_text)
    return np.asarray(img), np.asarray(txt)


def test_resnet_tower_matches_jax_through_the_converter():
    model_j, cfg, variables = _jax_model("test-rn", 4, perturb_stats=True)
    model = CLIP(CLIP_CONFIGS["test-rn"])
    missing, unexpected = model.load_state_dict(from_flax_variables(variables), strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    model.eval()
    images, tokens = _inputs(cfg)
    want_img, want_txt = _encode_jax(model_j, variables, images, tokens)
    with torch.inference_mode():
        got_img = model.encode_image(torch.from_numpy(images)).numpy()
        got_txt = model.encode_text(torch.from_numpy(tokens)).numpy()
    assert got_img.shape == (2, cfg.embed_dim)
    np.testing.assert_allclose(got_img, want_img, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_txt, want_txt, rtol=1e-4, atol=1e-4)


def test_resnet_state_dict_round_trip_through_both_converters(tmp_path):
    """Port model -> OpenAI-layout ``.pt`` -> (a) the port's ``load_clip``,
    (b) the JAX package's ``convert_state_dict``: the same features."""
    import jax.numpy as jnp

    from summer_clip_tpu.models.clip import convert as jconvert
    from summer_clip_tpu.models.clip.configs import build_clip as jax_build_clip

    model, cfg = build_clip("test-rn", torch.Generator().manual_seed(2), device="cpu")
    with torch.no_grad():                      # non-trivial running statistics
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.add_(0.1)
                m.running_var.mul_(1.5)
    sd = to_openai_state_dict(model)
    assert detect_model_name(sd) == "test-rn"
    assert sd["visual.layer1.0.downsample.0.weight"].dim() == 4
    path = tmp_path / "test_rn.pt"
    torch.save(sd, path)
    loaded, cfg2 = load_clip(path, device="cpu")
    assert cfg2.name == "test-rn"
    images, _ = _inputs(cfg, seed=1)
    with torch.inference_mode():
        want = model.encode_image(torch.from_numpy(images)).numpy()
        got = loaded.encode_image(torch.from_numpy(images)).numpy()
    np.testing.assert_array_equal(got, want)
    variables = jconvert.convert_state_dict(jconvert.load_torch_state_dict(path))
    model_j, _ = jax_build_clip("test-rn")
    got_j = np.asarray(model_j.apply(variables, jnp.asarray(images),
                                     method=model_j.encode_image))
    np.testing.assert_allclose(got_j, want, rtol=1e-4, atol=1e-4)


def test_resnet_runs_in_bf16_with_f32_norms():
    model, cfg = build_clip("test-rn", torch.Generator().manual_seed(3), dtype=torch.bfloat16,
                          device="cpu")
    ref, _ = build_clip("test-rn", torch.Generator().manual_seed(3), device="cpu")
    images, _ = _inputs(cfg, seed=2)
    with torch.inference_mode():
        got = model.encode_image(torch.from_numpy(images))
        want = ref.encode_image(torch.from_numpy(images))
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    cos = torch.nn.functional.cosine_similarity(got.float(), want, dim=-1)
    assert float(cos.min()) > 0.99


@pytest.mark.parametrize("name", list(SHAPES))
def test_block_routes_and_towers_match_jax(name, monkeypatch):
    import summer_clip_tpu.models.clip.configs as jconfigs

    cfg, routes = SHAPES[name]
    monkeypatch.setitem(CLIP_CONFIGS, name, cfg)
    monkeypatch.setitem(jconfigs.CLIP_CONFIGS, name, jconfigs.CLIPConfig(
        *dataclasses.astuple(cfg)))
    model_j, _, variables = _jax_model(name, 6)
    model = CLIP(cfg)
    model.load_state_dict(from_flax_variables(variables))
    model.eval()

    calls = {"k5": 0, "k6": 0, "k4": 0}

    def counting(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    import summer_clip_torch.models.clip.modeling as modeling
    monkeypatch.setattr(bk, "fused_ln_attn", counting("k5", bk.fused_ln_attn))
    monkeypatch.setattr(bk, "fused_ln_mlp", counting("k6", bk.fused_ln_mlp))
    monkeypatch.setattr(at, "short_attention_packed",
                        counting("k4", at.short_attention_packed))
    images, tokens = _inputs(cfg)
    with torch.inference_mode():
        got_img = model.encode_image(torch.from_numpy(images)).numpy()
    layers = int(cfg.vision_layers)
    assert calls == {"k5": layers * (routes[0] == "k5"), "k6": layers * (routes[1] == "k6"),
                     "k4": 0}   # on the CPU the K4 route runs the plain attention
    t = (cfg.image_resolution // cfg.vision_patch_size) ** 2 + 1
    assert bk.fused_attn_ok(t, cfg.vision_width, cfg.vision_heads) == (routes[0] == "k5")
    assert modeling.mlp_route(cfg.vision_width, t, cfg.vision_heads, 4 * cfg.vision_width) == (
        "k6" if routes[1] == "k6" else "plain")
    with torch.inference_mode():
        got_txt = model.encode_text(torch.from_numpy(tokens)).numpy()
    want_img, want_txt = _encode_jax(model_j, variables, images, tokens)
    np.testing.assert_allclose(got_img, want_img, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_txt, want_txt, rtol=1e-4, atol=1e-4)
    assert modeling.multi_head_attention is at.multi_head_attention


def _mode_routes(mode, block_routes, image_l14=False):
    """The routes of a tower's two halves under ``mode``: "block" keeps the
    block-mode table; "attn" and "xla" fuse no half; "mlp" sends only the
    ViT-L/14 image tower's MLP half to K9."""
    if mode == "block":
        return block_routes
    return ("k4", "k9" if mode == "mlp" and image_l14 else "plain")


@pytest.mark.parametrize("mode", ["block", "attn", "mlp", "xla"])
@pytest.mark.parametrize("name,image,text", [
    ("ViT-B/32", ("k5", "k6"), ("k5", "k6")), ("ViT-B/16", ("k5", "k6"), ("k5", "k6")),
    ("ViT-L/14", ("k4", "plain"), ("k5", "k6")),
    ("ViT-L/14@336px", ("k4", "plain"), ("k5", "k6")),
    ("RN50", None, ("k5", "k6")), ("RN101", None, ("k5", "k6"))])
def test_public_configs_take_the_jax_packages_routes(name, image, text, mode, monkeypatch):
    """The gates' outcome for every public tower in every ``FUSED_BLOCK_MODE``
    (the text towers are the 512- and 768-wide ones), and the JAX package's
    own gates and ``_mlp_dispatch`` (bf16, as on the chip) for the same
    geometry: ``"k4"`` is the attention route through ``multi_head_attention``."""
    import summer_clip_tpu.models.clip.modeling as jm
    from summer_clip_tpu.ops import block_kernels as jbk

    import summer_clip_torch.models.clip.modeling as pm

    cfg = CLIP_CONFIGS[name]
    monkeypatch.setattr(pm, "FUSED_BLOCK_MODE", mode)
    monkeypatch.setattr(jm, "FUSED_BLOCK_MODE", mode)
    monkeypatch.setattr(jm, "FUSED_BLOCK_FORCE", True)  # the backend check, not the geometry

    def routes(t, d, heads):
        return ("k5" if pm.attn_route(d, t, heads) == "k5" else "k4",
                pm.mlp_route(d, t, heads, 4 * d))

    def jax_routes(t, d, heads):
        chunked = 2 * d * 4 * d * 2 > jbk.FUSED_MLP_MAX_WEIGHT_BYTES
        return ("k5" if jm._fuse_attn_ok(d, t, heads, 2) else "k4",
                ("k9" if chunked else "k6") if jm._fuse_mlp_ok(d, t, heads, 2) else "plain")

    want_text = _mode_routes(mode, text)
    assert routes(cfg.context_length, cfg.text_width, cfg.text_heads) == want_text
    assert jax_routes(cfg.context_length, cfg.text_width, cfg.text_heads) == want_text
    if image is not None:
        t = (cfg.image_resolution // cfg.vision_patch_size) ** 2 + 1
        want = _mode_routes(mode, image, image_l14=(name == "ViT-L/14"))
        assert routes(t, cfg.vision_width, cfg.vision_heads) == want
        assert jax_routes(t, cfg.vision_width, cfg.vision_heads) == want
        assert t <= at.SHORT_MAX_T
