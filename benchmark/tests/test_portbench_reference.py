"""The plain reference against the port's CPU path at tiny sizes (the port on
the CPU runs its plain float32 versions), so the check compares like with
like; and the reference's tokenizer against the port's."""

import numpy as np
import pytest
import torch

from benchmark import traffic, weights
from benchmark.reference import cache as ref_cache
from benchmark.reference import clip as ref_clip
from benchmark.reference import tokenizer as ref_tok
from benchmark.tests.tiny import TINY_CONFIG


@pytest.fixture(scope="module")
def session_and_sd(tmp_path_factory):
    """The port's session through its loading path, over a checkpoint of both
    towers from seed 11."""
    from summer_clip_torch.apps.common import create_clip_session

    ckpt = weights.write_checkpoint(TINY_CONFIG, 11, "cpu",
                                    tmp_path_factory.mktemp("ckpt") / "clip.pt")
    session = create_clip_session(TINY_CONFIG["model_name"], checkpoint_path=str(ckpt),
                                  device="cpu")
    return session, weights.clip_state_dict(TINY_CONFIG, 11, "cpu")


def test_image_tower_matches_port(session_and_sd):
    session, sd = session_and_sd
    images = traffic.image_pool(3, 4, 32, "cpu")
    got = session.encode_image(images).float()
    want = ref_clip.encode_image({k: v.float() for k, v in sd.items()},
                                 torch.from_numpy(images), patch=8, heads=1)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_text_tower_and_tokens_match_port(session_and_sd):
    from summer_clip_torch.models.tokenizer import tokenize

    session, sd = session_and_sd
    prompts = ["a photo of apple pie, a type of food.", "a photo of pho, a type of food.",
               "a photo of a macaroni and cheese 2."]
    toks = ref_tok.tokenize(prompts)
    np.testing.assert_array_equal(toks, tokenize(prompts).astype(np.int64))
    got = session.encode_text(toks).float()
    want = ref_clip.encode_text({k: v.float() for k, v in sd.items()}, torch.from_numpy(toks),
                                heads=2)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_tip_grid_matches_search_hp():
    from summer_clip_torch.methods.tip import search_hp

    from benchmark.drivers.tip_search import grid_search

    gen = traffic.generator(5, "t", "cpu")
    c, d = 6, 16
    means = traffic.unit_rows(gen, c, d, "cpu")
    y = traffic.balanced_labels(gen, c, 7, "cpu")
    f = ref_cache.l2n(traffic.class_structured(gen, means, y, 1.5))
    kl = traffic.balanced_labels(gen, c, 3, "cpu", shuffle=False)
    k = ref_cache.l2n(traffic.class_structured(gen, means, kl, 1.5))
    cl = 100 * f @ ref_cache.l2n(traffic.class_structured(gen, means, torch.arange(c), 2.0)).t()
    values = torch.nn.functional.one_hot(kl, c).float().numpy()
    logged = []
    beta, alpha, acc = search_hp(f.numpy(), y.numpy(), cl, k.numpy(), values, (7, 3), (40, 5),
                                 beta_chunk=16, log_fn=logged.append,
                                 cache_labels=kl.numpy().astype(np.int32), device="cpu")
    betas, alphas = ref_cache.beta_alpha_grid((7, 3), (40, 5))
    grid = ref_cache.tip_grid(f, y, cl, k, kl, c, betas, alphas)
    want = grid_search(grid, betas, alphas, 16)
    assert (beta, alpha) == (want["beta"], want["alpha"])
    assert acc == pytest.approx(want["acc"], abs=1e-4)
    assert [(r["beta"], r["alpha"]) for r in logged] == \
        [(r["beta"], r["alpha"]) for r in want["logged"]]


def test_clip_search_grid_matches_port_cache_logits():
    from summer_clip_torch.methods.cache import cache_logits_for_betas
    from summer_clip_torch.methods.zeroshot import label_rank

    gen = traffic.generator(6, "c", "cpu")
    c, d = 5, 16
    means = traffic.unit_rows(gen, c, d, "cpu")
    y = traffic.balanced_labels(gen, c, 6, "cpu")
    test = traffic.class_structured(gen, means, y, 1.0)
    cache_y = traffic.balanced_labels(gen, c, 8, "cpu")
    cache = traffic.class_structured(gen, means, cache_y, 1.0)
    outs = traffic.pseudo_outs(gen, cache_y, c, base=0.2, spread=0.01, margin=0.03,
                               correct_share=0.7)
    tn = ref_cache.l2n(test)
    cl = 100 * tn @ traffic.unit_rows(gen, c, d, "cpu").t()
    scales, betas, alphas = [0.1, 1.0], [1.0, 5.5], [0.0, 2.0]
    grid = ref_cache.clip_search_grid(tn, y, cl, cache, outs, scales, 100.0, betas, alphas)
    for vi, s in enumerate(scales):
        v = torch.softmax(100.0 * s * outs, dim=1).numpy()
        logits = cache_logits_for_betas(test.numpy(), cache.numpy(), v, betas, device="cpu")
        for bi in range(len(betas)):
            for ai, a in enumerate(alphas):
                rank = label_rank(cl + a * logits[bi], y)
                assert grid[vi, bi, ai, 0] == pytest.approx(float((rank == 0).float().mean() * 100),
                                                            abs=1e-4)
                assert grid[vi, bi, ai, 1] == pytest.approx(float((rank < 5).float().mean() * 100),
                                                            abs=1e-4)
