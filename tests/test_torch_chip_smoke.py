"""``chip_smoke.py``'s options on a machine without a card: ``--only`` picks
one kernel family's checks, ``--baseline`` earlier copies of its sources to
time in turns, and the script refuses to run (exit 2, no result) without
CUDA. The checks themselves run only on the card, except the sandbox
path's, rehearsed here at test-gpt with K4's route forced."""

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
    """Every kernel entry carries launches for all thirteen paths, train_gpt,
    int8_towers, sandbox, multi_device_train and jpeg_extract among them, and
    ``launches`` is their sum."""
    paths = list(chip_smoke.MAIN_PATHS)
    assert paths[-3:] == ["train_gpt", "int8_towers", "sandbox"]
    assert len(paths) == 13 and {"multi_device_train", "jpeg_extract"} <= set(paths)
    assert chip_smoke.MAIN_PATHS["jpeg_extract"] == ("K5 fused_ln_attn", "K6 fused_ln_mlp")
    launches = {p: {n: 0 for n in chip_smoke.KERNELS} for p in paths}
    launches["jpeg_extract"]["K5 fused_ln_attn"] = 1572
    launches["multi_device_train"]["K4 short_attention_packed"] = 1980
    launches["train_gpt"]["K4 short_attention_packed"] = 396
    launches["int8_towers"]["K4 short_attention_packed"] = 24
    launches["clip_search"]["K4 short_attention_packed"] = 2280
    launches["sandbox"]["K4 short_attention_packed"] = 1044
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
    assert k4["launches_by_path"]["sandbox"] == 1044
    assert k4["launches_by_path"]["multi_device_train"] == 1980
    assert k4["launches"] == 396 + 24 + 2280 + 1044 + 1980
    k5 = next(e for e in on if e["name"] == "K5 fused_ln_attn")
    assert k5["launches_by_path"]["jpeg_extract"] == k5["launches"] == 1572
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


def test_sandbox_launch_arithmetic(tmp_path):
    """The sandbox path's K4 counts: 36 a wide gpt2-large forward, none in a
    backward; optimise_input's forwards; the trigger search's forwards; the
    generated trigger data's sizes."""
    assert chip_smoke.MAIN_PATHS["sandbox"] is chip_smoke.SANDBOX_PATH
    assert chip_smoke.sandbox_k4_launches(2) == 72
    assert chip_smoke.backwards_forwards(4, 2) == 12
    assert chip_smoke.backwards_forwards(4, 2, out_len=3) == 24
    history = [{"iter": -1}, {"accepted": False}, {"accepted": True}]
    assert chip_smoke.trigger_forwards(history) == 1 + 8 + 9
    data = chip_smoke.write_trigger_data(tmp_path)
    for split, n in chip_smoke.TRIGGER_ROWS.items():
        lines = data[split].read_text().splitlines()
        assert lines[0] == "sentence\tlabel" and len(lines) == n + 1
        assert {line.split("\t")[1] for line in lines[1:]} <= set(chip_smoke.TRIGGER_LABELS)


def test_sandbox_path_rehearsed_on_the_cpu(tmp_path, monkeypatch):
    """``run_sandbox`` and ``check_sandbox`` at test-gpt on the CPU: the
    attention route forced to K4's (whose wrapper runs its plain version on
    CPU tensors), each K4 call counted where the card would launch it, a
    chunk size small enough for the chunked leaf; the path's launch
    arithmetic, its gates and its planted fault hold as on the card."""
    import torch

    from summer_clip_torch.core import device as dev
    from summer_clip_torch.engine import checkpoint as C
    from summer_clip_torch.ops import attention as at

    route, real = at.attention_route, at.short_attention_packed

    def k4(*args, **kwargs):
        k4.launches += 1
        return real(*args, **kwargs)

    k4.launches = 0
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(dev, "resolve_device", lambda name=None: torch.device("cpu"))
    monkeypatch.setattr(at, "attention_route", lambda **kw: route(**{**kw, "on_card": True}))
    monkeypatch.setattr(at, "short_attention_packed", k4)
    monkeypatch.setattr(chip_smoke, "launch_counters",
                        lambda: {"K4 short_attention_packed": at.short_attention_packed})
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "no card")
    monkeypatch.setattr(chip_smoke, "SANDBOX_MODEL", "test-gpt")
    monkeypatch.setattr(chip_smoke, "CHUNKED_LEAF_BYTES", 4096)
    monkeypatch.setattr(C, "MAX_CHUNK_SIZE", 1024)
    out = chip_smoke.run_sandbox(tmp_path, lambda: {"K4 short_attention_packed": k4.launches})
    assert out["launches"]["backwards"] == {"K4 short_attention_packed": 2 * 2 * (4 + 2)}
    assert out["launches"]["generate"] == {}
    chip_smoke.check_sandbox(out)
    assert at.short_attention_packed is k4


def test_kernels_line_lists_multi_device():
    """The ``multi_device`` path (phase (p)) has its entry in every kernel's
    ``launches_by_path``, and its launches count in ``launches``."""
    assert chip_smoke.MAIN_PATHS["multi_device"] is chip_smoke.MULTI_PATH
    assert {"K1 cache_dense", "K2 labels_dense", "K3 onehot_grouped",
            "K7 streamed_qmatmul"} <= set(chip_smoke.MULTI_PATH)
    paths = list(chip_smoke.MAIN_PATHS)
    launches = {p: {n: 0 for n in chip_smoke.KERNELS} for p in paths}
    launches["gen_gpt"]["K7 streamed_qmatmul"] = 25645
    launches["multi_device"]["K7 streamed_qmatmul"] = 2 * (8817 + 9410 + 2793) + 8817
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    results = {n: {"max_abs_err": 0.0, **{k: 1.0 for k in keys},
                   "shapes": {s: {k: 1.0 for k in keys} for s in (shape,)} if shape else {}}
               for n, (_, _, shape) in chip_smoke.KERNELS.items()}
    on, _ = chip_smoke.kernels_lines(results, launches)
    k7 = next(e for e in on if e["name"] == "K7 streamed_qmatmul")
    assert k7["launches_by_path"]["multi_device"] == 2 * (8817 + 9410 + 2793) + 8817
    assert k7["launches"] == 25645 + 2 * (8817 + 9410 + 2793) + 8817


def test_tp_k7_launch_arithmetic():
    """K7 launches a rank makes a decoded token of the int8 ClipGPT under TP:
    at gpt2-large every slice at tp = 2 ((1280, 1920), (640, 1280), (1280, 2560),
    (2560, 1280)) and tp = 4 (c_proj's K = 320) is tile-legal, so a rank makes
    the one-device route's 147 (4 a block, 2 adapters, the hoisted head). At
    test-gpt-mega's widths the count is 11 a token (2 blocks), which the
    decoder's own calls confirm on the CPU (counted at K7's wrapper on rank
    0's slices of a 1 x 2 mesh)."""
    import torch

    from summer_clip_torch.apps import gen_gpt
    from summer_clip_torch.engine.quant import quantize_tree
    from summer_clip_torch.models.gpt2 import GPT2_CONFIGS, ClipGPT
    from summer_clip_torch.ops import gemv
    from summer_clip_torch.ops.gemv import _tile_legal
    from summer_clip_torch.parallel import Mesh
    from summer_clip_torch.parallel.tp_int8 import TPInt8Decoder

    large = GPT2_CONFIGS["gpt2-large"]
    assert [chip_smoke.tp_k7_per_token(large, t) for t in (1, 2, 4)] == [147, 147, 147]
    for k, n in ((1280, 1920), (640, 1280), (1280, 2560), (2560, 1280), (320, 1280)):
        assert _tile_legal(k, n, 1)
    mega = GPT2_CONFIGS["test-gpt-mega"]
    assert chip_smoke.tp_k7_per_token(mega, 2, clip_emb=128, hid=128, vocab=512) == 11

    model = ClipGPT(mega, clip_vocab_size=512, clip_emb_dim=128, emb_hid_dim=128,
                    head_hid_dim=128, device="cpu").init_weights(torch.Generator().manual_seed(0))
    model = model.with_tree(quantize_tree(model.tree())).eval()
    mesh = Mesh({"data": 1, "model": 2}, {"data": 0, "model": 0}, 0, torch.device("cpu"),
                {"data": None, "model": None})
    dec = TPInt8Decoder(model, mesh)
    head = gen_gpt._head(dec, True)
    calls = {"n": 0}
    real = gemv.streamed_qmatmul

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    gemv.streamed_qmatmul = counted
    try:
        cache = dec.init_cache(1, 8)
        out = dec(torch.tensor([[3, 4, 5]]), cache=cache, compute_logits=False)
        calls["n"] = 0
        with torch.inference_mode():
            out = dec(torch.tensor([[6]]), position_offset=3, cache=out["cache"],
                      compute_logits=False)
            head(out["hidden"][:, -1, :])
    finally:
        gemv.streamed_qmatmul = real
    assert calls["n"] == 11
    assert cache[0]["k"].shape == (1, 8, 128)     # the rank's half of the embedding dim


def test_shared_towers_draw_once_and_leave_the_global_generator_as_a_build_would():
    """Inside ``shared_towers`` an app's second session of the same random
    model takes the first one's towers, and torch's global generator ends
    where a build would have left it, from the same start or another; outside,
    every build draws anew."""
    from summer_clip_torch.apps import common

    def session(seed):
        torch.manual_seed(seed)
        model, _ = common.build_clip("test-vit", torch.Generator().manual_seed(0),
                                     dtype=torch.float32, device="cpu")
        return model, torch.rand(4)

    want = {seed: session(seed) for seed in (42, 7)}
    with chip_smoke.shared_towers():
        first, after = session(42)
        for seed in (42, 7, 42):
            model, after = session(seed)
            assert model is first
            torch.testing.assert_close(after, want[seed][1], rtol=0, atol=0)
        other, _ = common.build_clip("test-vit", torch.Generator().manual_seed(1),
                                     dtype=torch.float32, device="cpu")
        assert other is not first
    torch.testing.assert_close(first.visual.proj, want[42][0].visual.proj, rtol=0, atol=0)
    assert session(42)[0] is not first
