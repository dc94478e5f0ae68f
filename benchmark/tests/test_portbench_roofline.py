"""The work counts of ``roofline.py`` against hand counts at small shapes."""

import pytest

from benchmark import roofline as R


def test_peaks_and_exponential_rate():
    card = R.Card(sms=132, sm_clock_hz=1.98e9)
    assert R.EXP_PER_CLOCK_SM == 16 + 128 / 4 == 48
    assert card.exp_rate == pytest.approx(48 * 132 * 1.98e9)
    # the least time: the larger of bytes and operations, exponentials beside
    w = R.Work(bytes=3.35e12, bf16_flops=989e12, f32_flops=67e12, exps=card.exp_rate * 3)
    assert R.least_seconds(w, card) == pytest.approx(3.0)
    assert R.least_seconds(R.Work(bytes=3.35e12 * 5, bf16_flops=989e12), card) == pytest.approx(5)


def test_attention_by_hand():
    # B=2, T=3, D=4 (2 heads of 2): q, k, v, o of 2*3*4 bf16 each; QK^T and PV
    # 2 * (B * H * T * T * hd) each; one exponential a score
    w = R.attention(2, 3, 4, 2)
    assert w.bytes == 4 * 24 * 2
    assert w.bf16_flops == 2 * (2 * 2 * 3 * 3 * 2) * 2
    assert w.exps == 2 * 2 * 3 * 3
    causal = R.attention(1, 3, 4, 2, causal=True)       # rows reach 1, 2, 3 keys: mean 2
    assert causal.exps == 1 * 2 * 3 * 2


def test_block_halves_by_hand():
    b, t, d, h, hid = 1, 2, 4, 2, 16
    attn = R.fused_attn_half(b, t, d, h)
    assert attn.bf16_flops == 2 * 2 * 4 * 12 + 4 * 1 * 2 * 2 * 4 + 2 * 2 * 4 * 4
    assert attn.bytes == 2 * 8 * 2 + (64 + 16) * 2 + 8 * 4
    mlp = R.fused_mlp_half(b, t, d, hid)
    assert mlp.bf16_flops == 2 * (2 * 2 * 4 * 16)
    assert mlp.bytes == 2 * 8 * 2 + (2 * 64 + 16 + 4) * 2 + 8 * 4
    chain = R.block_chain(b, t, d, h, hid)
    assert chain.bf16_flops == attn.bf16_flops + mlp.bf16_flops


def test_vit_image_flops_by_hand():
    # 8 px images, patch 4: 4 patches + class = 5 tokens, width 2, one layer
    got = R.vit_image_flops(8, 4, 2, 1, 3)
    patch = 2 * 4 * (3 * 16) * 2
    block = 2 * 5 * 2 * 6 + 4 * 5 * 5 * 2 + 2 * 5 * 2 * 2 + 2 * 2 * 5 * 2 * 8
    assert got == patch + block + 2 * 2 * 3
    # ViT-B/16 and ViT-L/14 at the published shapes: ~35 and ~162 GFLOP an image
    assert R.vit_image_flops(224, 16, 768, 12, 512) == pytest.approx(35.2e9, rel=0.01)
    assert R.vit_image_flops(224, 14, 1024, 24, 768) == pytest.approx(162e9, rel=0.01)


def test_cache_counts_by_hand():
    lab = R.label_cache(3, 5, 4, 2, 2)
    assert lab.bytes == 2 * 8 * 4 + 4 * 5 + 4 * 2 * 3 * 2
    assert (lab.bf16_flops, lab.f32_flops, lab.exps) == (2 * 3 * 5 * 4, 30, 30)
    dense = R.dense_cache(3, 5, 4, 2, 2)
    assert dense.bytes == 2 * 8 * 4 + 2 * 5 * 2 + 4 * 2 * 3 * 2
    assert dense.bf16_flops == 2 * 3 * 5 * 4 + 2 * 2 * 3 * 5 * 2 and dense.exps == 30
    tip = R.tip_search(3, 5, 4, 2, 2, 7)
    assert tip.bytes == lab.bytes + 2 * (2 * 4 * 3 * 2)
    assert tip.f32_flops == lab.f32_flops + 2 * (2 * 7 * 3 * 2)
    cs = R.clip_search_pass(3, 5, 4, 2, 2, 7, 3)
    assert cs.exps == 3 * (5 * 2 + dense.exps)
    assert cs.f32_flops == 3 * 2 * (3 * 7 * 3 * 2)
