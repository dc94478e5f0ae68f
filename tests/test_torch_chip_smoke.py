"""``chip_smoke.py``'s options on a machine without a card: ``--only`` picks
one kernel family's checks, ``--baseline`` earlier copies of its sources to
time in turns, and the script refuses to run (exit 2, no result) without
CUDA. The checks themselves run only on the card."""

import pytest
import torch

import chip_smoke


@pytest.mark.parametrize("only,source", [("attention", "attention_kernels"),
                                         ("block", "block_kernels"),
                                         ("cache", "cache_kernels"),
                                         ("decode", "decode_kernels")])
def test_only_names_a_source_whose_wrappers_declare_its_entries(only, source):
    assert chip_smoke.ONLY_SOURCES[only] == source
    assert source in chip_smoke.KERNEL_SOURCES
    signatures = chip_smoke._ops_module(source)._SIGNATURES
    assert signatures and all(isinstance(v, list) for v in signatures.values())


def test_baseline_needs_only(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(["--baseline", "old/cache_kernels.cu"])
    assert exc.value.code == 2
    assert "--baseline needs --only" in capsys.readouterr().err


def test_unknown_only_is_refused():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(["--only", "gemv"])
    assert exc.value.code == 2


@pytest.mark.parametrize("argv", [[], ["--only", "block"],
                                  ["--only", "cache", "--baseline", "old/cache_kernels.cu"],
                                  ["--only", "decode", "--baseline", "old/gemv_kernels.cu",
                                   "old/decode_kernels.cu"]])
def test_no_card_no_result(argv, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main(argv) == 2
    out = capsys.readouterr()
    assert out.out == "" and "only on a CUDA card" in out.err


def test_baseline_must_be_a_source_of_the_family(capsys):
    """``--only decode`` builds gemv_kernels and decode_kernels; an old copy of
    any other source is refused before anything is built."""
    assert chip_smoke.ONLY_BUILDS["decode"] == ("gemv_kernels", "decode_kernels")
    assert chip_smoke.baseline_source("decode", "x/gemv_kernels.cu") == "gemv_kernels"
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(["--only", "decode", "--baseline", "old/cache_kernels.cu"])
    assert exc.value.code == 2
    assert "gemv_kernels.cu or decode_kernels.cu" in capsys.readouterr().err


def test_workspace_entries_are_the_ones_the_cluster_designs_replaced():
    """An earlier ``gemv_kernels.cu`` or ``decode_kernels.cu`` (the workspace-
    and-ticket design) is timed on its own entries: the tree's sources no
    longer have them, and have the cluster designs'."""
    from summer_clip_torch.ops import _lib

    gemv_src = (_lib.CSRC_DIR / "gemv_kernels.cu").read_text()
    decode_src = (_lib.CSRC_DIR / "decode_kernels.cu").read_text()
    for name in chip_smoke.WORKSPACE_K7_SIGNATURES:
        assert f"int {name}(" not in gemv_src
    assert "int cluster_qmatmul_i8(" in gemv_src
    assert "int decode_block(" not in decode_src and "int decode_stack(" in decode_src
    assert "tickets" not in gemv_src.split("// K10")[0] and "tickets" not in decode_src


def test_two_launch_k10_entry_is_the_one_the_single_launch_replaced():
    """An earlier ``gemv_kernels.cu`` whose K10 is two launches (it has
    ``qmlp_reduce_kernel``) is timed on its own K10 entry; the tree's source
    launches K10 once, and each of its entries takes as many parameters as the
    wrapper module declares."""
    import re

    from summer_clip_torch.ops import _lib, gemv

    src = (_lib.CSRC_DIR / "gemv_kernels.cu").read_text()
    assert "qmlp_reduce_kernel" not in src
    for name, argtypes in gemv._SIGNATURES.items():
        params = re.search(rf"int {name}\(([^)]*)\)", src).group(1)
        assert len(params.split(",")) == len(argtypes), name
    assert len(chip_smoke.TWO_LAUNCH_K10_SIGNATURES["fused_qmlp_i8"]) == 13


def test_baseline_times_nothing_without_a_baseline_build():
    chip_smoke.BASELINE.clear()
    assert chip_smoke.baseline_ms(lambda: None, 3, "cache_kernels") is None


def test_block_baseline_times_nothing_without_a_baseline_build():
    chip_smoke.BASELINE.clear()
    assert chip_smoke.baseline_block_ms(lambda: None, "K5 fused_ln_attn", (), 12, False, 3) is None


def test_per_head_block_entries_are_the_ones_the_gemm_chain_replaced():
    """A ``block_kernels.cu`` from before the GEMM chain is timed on its own
    K5 and K6 entries: the tree's source no longer has them, and has the
    chain's."""
    from summer_clip_torch.ops import _lib

    src = (_lib.CSRC_DIR / "block_kernels.cu").read_text()
    for name in chip_smoke.PER_HEAD_BLOCK_SIGNATURES:
        assert f"int {name}(" not in src
    assert "int ln_rows_bf16(" in src and "int block_gemm_bf16(" in src


@pytest.mark.parametrize("tower", sorted(chip_smoke.BLOCK_SHAPES))
def test_block_shapes_are_the_towers_the_paths_run(tower):
    """Each shape the block checks time is a tower's residual block as the
    paths give it: the model config's widths and tokens, and for CoOp one
    prompt a class of ``synthetic_1k``, the dataset ``train_coop`` runs on."""
    from summer_clip_torch.data.datasets import SyntheticImageNetScale
    from summer_clip_torch.models.clip.configs import CLIP_CONFIGS

    model, half = {"vit_b16_image": ("ViT-B/16", "image"), "vit_b16_text": ("ViT-B/16", "text"),
                   "vit_l14_text": ("ViT-L/14", "text"), "coop_l14_text": ("ViT-L/14", "text"),
                   "vit_l14_image": ("ViT-L/14", "image")}[tower]
    cfg = CLIP_CONFIGS[model]
    if half == "image":
        want = ((cfg.image_resolution // cfg.vision_patch_size) ** 2 + 1, cfg.vision_width,
                cfg.vision_heads, False)
    else:
        want = (cfg.context_length, cfg.text_width, cfg.text_heads, True)
    b, *shape = chip_smoke.BLOCK_SHAPES[tower]
    assert tuple(shape) == want
    if tower == "coop_l14_text":
        assert b == len(SyntheticImageNetScale().classnames)


def test_train_gpt_and_int8_paths_run_k4():
    """The two paths of the ClipGPT trainer and the int8 towers: K4 alone (the
    int8 blocks take the module route, never K5, K6 or K9)."""
    assert chip_smoke.TRAIN_GPT_PATH == chip_smoke.INT8_PATH == ("K4 short_attention_packed",)
    assert chip_smoke.MAIN_PATHS["train_gpt"] is chip_smoke.TRAIN_GPT_PATH
    assert chip_smoke.MAIN_PATHS["int8_towers"] is chip_smoke.INT8_PATH


def test_train_gpt_launch_arithmetic():
    """36 blocks: each micro-step's forward launches K4 once a block and remat's
    recompute once more; each eval batch (no grad) once. The phase's corpora
    give 5 micro-steps and 1 eval batch of 32 under the app's window rule."""
    from summer_clip_torch.apps.train_gpt import eval_starts

    assert chip_smoke.train_gpt_k4_launches(5, 1) == 36 * 11
    assert chip_smoke.train_gpt_k4_launches(5, 1, remat=False) == 36 * 6
    assert int(chip_smoke.TRAIN_GPT_SUBPART * 244) // chip_smoke.TRAIN_GPT_BATCH == \
        chip_smoke.TRAIN_GPT_MICRO
    assert chip_smoke.TRAIN_GPT_MICRO % 2 == 1 and chip_smoke.TRAIN_GPT_MICRO // \
        chip_smoke.TRAIN_GPT_ACCUM == 2
    assert list(eval_starts(55, 32)) == [0]
    assert list(eval_starts(32, 32)) == [0] and list(eval_starts(100, 32)) == [0, 32, 64]
    assert list(eval_starts(30, 32)) == []


def test_train_gpt_corpora_have_the_phase_sizes(tmp_path):
    """tokenize_dataset at max_length 80: 244 training chunks from 64 synthetic
    documents, 55 validation chunks from 12."""
    from summer_clip_torch.apps.tokenize_dataset import iter_corpus_texts, tokenize_texts
    from summer_clip_torch.core.config import ConfigNode
    from summer_clip_torch.models.tokenizer import get_tokenizer

    tok = get_tokenizer()
    for docs, rows in ((chip_smoke.TRAIN_GPT_DOCS, 244), (chip_smoke.TRAIN_GPT_VAL_DOCS, 55)):
        got = tokenize_texts(iter_corpus_texts(ConfigNode({"kind": "synthetic", "n_docs": docs})),
                             tok, chip_smoke.TRAIN_GPT_T)
        assert got.shape == (rows, 80)


def test_kernels_line_lists_every_path():
    """Every kernel entry carries launches for all nine paths, train_gpt and
    int8_towers among them, and ``launches`` is their sum."""
    paths = list(chip_smoke.MAIN_PATHS)
    assert paths[-2:] == ["train_gpt", "int8_towers"]
    launches = {p: {n: 0 for n in chip_smoke.KERNELS} for p in paths}
    launches["train_gpt"]["K4 short_attention_packed"] = 396
    launches["int8_towers"]["K4 short_attention_packed"] = 24
    launches["clip_search"]["K4 short_attention_packed"] = 2280
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    results = {n: {"max_abs_err": 0.0, **{k: 1.0 for k in keys},
                   "shapes": {s: {k: 1.0 for k in keys} for s in (shape,)} if shape else {}}
               for n, (_, _, shape) in chip_smoke.KERNELS.items()}
    on, off = chip_smoke.kernels_lines(results, launches)
    assert [e["name"] for e in off] == ["K12 short_attention"]
    k4 = next(e for e in on if e["name"] == "K4 short_attention_packed")
    assert set(k4["launches_by_path"]) == set(paths)
    assert k4["launches_by_path"]["train_gpt"] == 396
    assert k4["launches_by_path"]["int8_towers"] == 24
    assert k4["launches"] == 396 + 24 + 2280
    assert all({"name", "route", "source", "replaces", "launches", "max_abs_err", *keys}
               <= set(e) for e in on + off)


def test_train_gpt_bound_counts_a_micro_step():
    """About 15 TFLOP of bf16 products a micro-step at gpt2-large (forward,
    every leaf's gradients, remat's forward again) and the head's three f32
    products, so the bound is set by operations."""
    from summer_clip_torch.models.gpt2 import GPT2_CONFIGS

    b = chip_smoke.train_gpt_bound(GPT2_CONFIGS["gpt2-large"], 49408)
    assert b["bound_by"] == "operations"
    assert 20 < b["bound_ms"] < 40
