"""The port's CLIP towers, weight conversion and methods against the JAX package.

Towers: the JAX package's ``init_clip`` variables go through
``from_flax_variables`` into the port's modules; both encode the same numpy
inputs on the CPU in f32 and agree to 1e-4. Methods (``label_rank``,
``accuracy``, ``search_hp``, ``zeroshot_classifier``) take the same inputs and
must give the same answers.
"""

import dataclasses

import numpy as np
import pytest
import torch

from summer_clip_torch.models.clip import (CLIP, CLIP_CONFIGS, build_clip, detect_model_name,
                                           from_flax_variables, to_openai_state_dict)


def test_config_table_matches_jax():
    from summer_clip_tpu.models.clip.configs import CLIP_CONFIGS as JAX_CONFIGS

    assert list(CLIP_CONFIGS) == list(JAX_CONFIGS)
    for name, cfg in CLIP_CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(JAX_CONFIGS[name]), name
        assert cfg.vision_heads == JAX_CONFIGS[name].vision_heads


@pytest.fixture(scope="module")
def towers():
    import jax

    from summer_clip_tpu.models.clip import init_clip

    model_j, _, variables = init_clip("test-vit", jax.random.PRNGKey(5))
    model = CLIP(CLIP_CONFIGS["test-vit"])
    model.load_state_dict(from_flax_variables(jax.tree_util.tree_map(np.asarray, variables)))
    return model_j, variables, model.eval()


def test_towers_match_jax(towers):
    import jax.numpy as jnp

    model_j, variables, model = towers
    rng = np.random.default_rng(0)
    images = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    tokens = rng.integers(1, 400, (3, 16)).astype(np.int32)
    tokens[:, 5] = 511                                   # the argmax id pools
    embeds = (rng.standard_normal((3, 16, 32)) * 0.02).astype(np.float32)
    lens = np.asarray([3, 16, 9], np.int32)

    def jx(method, *args):
        return np.asarray(model_j.apply(variables, *map(jnp.asarray, args), method=method))

    with torch.inference_mode():
        got = [model.encode_image(torch.from_numpy(images)),
               model.encode_image_preproj(torch.from_numpy(images)),
               model.encode_text(torch.from_numpy(tokens)),
               model.encode_text_embeds(torch.from_numpy(embeds), torch.from_numpy(lens))]
    want = [jx(model_j.encode_image, images), jx(model_j.encode_image_preproj, images),
            jx(model_j.encode_text, tokens), jx(model_j.encode_text_embeds, embeds, lens)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)


def test_openai_state_dict_round_trips_through_jax_converter(towers):
    from summer_clip_tpu.models.clip.convert import convert_state_dict

    _, variables, model = towers
    sd = {k: v.numpy() for k, v in to_openai_state_dict(model).items()}
    assert detect_model_name(sd) == "test-vit"
    back = convert_state_dict(sd)
    import jax

    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(variables["params"]),
                                jax.tree_util.tree_leaves_with_path(back["params"])):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_build_clip_is_seeded_and_keeps_layernorm_f32():
    a, _ = build_clip("test-vit", torch.Generator().manual_seed(1), dtype=torch.bfloat16,
                      device="cpu")
    b, _ = build_clip("test-vit", torch.Generator().manual_seed(1), dtype=torch.bfloat16,
                      device="cpu")
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
        want = torch.float32 if ("ln_" in n or n == "logit_scale") else torch.bfloat16
        assert p.dtype == want, n
    assert float(a.transformer.resblocks[0].attn.out_proj.bias.abs().max()) == 0.0
    rn, _ = build_clip("test-rn", torch.Generator().manual_seed(1), dtype=torch.bfloat16,
                      device="cpu")
    for n, p in rn.visual.named_parameters():
        is_norm = ".bn" in f".{n}" or "downsample.1" in n
        assert p.dtype == (torch.float32 if is_norm else torch.bfloat16), n


@pytest.mark.parametrize("k", [1, 5])
def test_label_rank_and_accuracy_ties_match_jax(k):
    import jax
    import jax.numpy as jnp

    from summer_clip_tpu.methods import zeroshot as jz
    from summer_clip_torch.methods import zeroshot as tz

    rng = np.random.default_rng(0)
    logits = np.round(rng.standard_normal((64, 11)).astype(np.float32) * 2) / 2
    labels = rng.integers(0, 11, 64)
    rank = tz.label_rank(torch.from_numpy(logits), torch.from_numpy(labels)).numpy()
    np.testing.assert_array_equal(
        rank, np.asarray(jz.label_rank(jnp.asarray(logits), jnp.asarray(labels))))
    top = np.asarray(jax.lax.top_k(jnp.asarray(logits), k)[1])
    np.testing.assert_array_equal(rank < k, (top == labels[:, None]).any(1))
    assert tz.accuracy(torch.from_numpy(logits), labels, topk=(1, k)) == \
        jz.accuracy(logits, labels, topk=(1, k))
    assert tz.compute_accuracy(logits, labels) == jz.compute_accuracy(logits, labels)


def test_search_hp_and_tip_logits_match_jax():
    from summer_clip_tpu.methods import tip as jtip
    from summer_clip_torch.methods import tip as ttip

    rng = np.random.default_rng(1)
    n, nk, d, c = 40, 12, 16, 4
    unit = lambda a: (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)  # noqa
    feats = unit(rng.standard_normal((n, d)))
    labels = rng.integers(0, c, n)
    passes = [rng.standard_normal((nk, d)).astype(np.float32) for _ in range(2)]
    keys, values = jtip.build_cache_from_features(passes, np.repeat(np.arange(c), nk // c), c)
    tkeys, tvalues = ttip.build_cache_from_features(passes, np.repeat(np.arange(c), nk // c), c)
    np.testing.assert_array_equal(tkeys, keys)
    np.testing.assert_array_equal(tvalues, values)
    cl = (10 * feats @ unit(rng.standard_normal((c, d))).T).astype(np.float32)
    cache_labels = np.argmax(values, 1).astype(np.int32)
    kw = dict(search_scale=(7, 3), search_step=(20, 5))
    want = jtip.search_hp(feats, labels, cl, keys, values, **kw)
    for lab in (None, cache_labels):
        got = ttip.search_hp(feats, labels, cl, keys, values, cache_labels=lab, device="cpu",
                             **kw)
        assert got == pytest.approx(want, abs=1e-6)
    np.testing.assert_allclose(
        ttip.tip_logits(cl, feats, keys, values, 2.0, 1.5, cache_labels=cache_labels,
                        device="cpu").numpy(),
        np.asarray(jtip.tip_logits(cl, feats, keys, values, 2.0, 1.5)), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ttip.beta_alpha_grid((7, 3), (200, 20))[0],
                                  jtip.beta_alpha_grid((7, 3), (200, 20))[0])


def test_zeroshot_classifier_matches_jax(towers):
    import jax.numpy as jnp

    from summer_clip_tpu.methods.zeroshot import zeroshot_classifier as jzs
    from summer_clip_torch.methods.zeroshot import zeroshot_classifier as tzs

    model_j, variables, model = towers
    classes, templates = ["cat", "big_dog", "car"], ["a photo of a {}.", "a {} photo."]

    def enc_j(tok):
        return model_j.apply(variables, jnp.asarray(tok)[:, :16], method=model_j.encode_text)

    with torch.inference_mode():
        got = tzs(lambda tok: model.encode_text(tok[:, :16]), classes, templates, chunk_size=4,
                  device="cpu")
    want = np.asarray(jzs(enc_j, classes, templates, chunk_size=4))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
