#!/usr/bin/env python3
"""Run the PyTorch port (``summer_clip_torch``) on one CUDA card, end to end.

    python3 chip_smoke.py

1. Refuses to run without CUDA. Prints the card (``nvidia-smi`` name and power
   limit) and the torch, CUDA, nvcc and Triton versions.
2. Builds every kernel from ``summer_clip_torch/csrc`` with nvcc, one process
   per source, all started together (``-Xptxas -v`` report printed).
3. Holds each kernel against its plain PyTorch version on the card at the
   shapes of the main paths, with the tolerances below, and times both with
   CUDA events (TF32 off for the plain f32 products):
   - K5 fused_ln_attn and K6 fused_ln_mlp at the ViT-B/16 image tower
     (B=32, T=197, D=768, 12 heads), its text tower (B=256, T=77, D=512,
     8 heads, causal) and the ViT-L/14 text tower (B=256, T=77, D=768, 12
     heads, causal);
   - K4 short_attention_packed at the ViT-L/14 image tower (B=32, T=257,
     D=1024, 16 heads) and at text shapes (B=256, T=77, D=512, 8 heads,
     causal), K12 short_attention at (512, 257, 64); for both also
     ``F.scaled_dot_product_attention`` on the same q/k/v, timed as the
     library yardstick and used nowhere in the port;
   - K3 onehot_grouped on a class-grouped Tip cache (Nt=8192, Nc=16*1000,
     D=512, C=1000, 16 betas of the Tip grid) and K2 labels_dense on the same
     cache with its rows shuffled; K3 == K2 on the grouped cache; K3 once more
     as CLIP-search gives it (Nt=1000, D=768, a prediction-sorted selection
     padded with label -1 to 1024 or 2048 rows, 8 betas);
   - K1 cache_dense at Nt=8192, Nc=16384, D=768, C=1000, 8 betas (CLIP-search's
     beta chunk) with bf16 softmax values and with int8 one-hot values, the
     latter also against K2 on the same labels; K1 once more at the pipeline's
     own size (Nt=1000, Nc=2048);
   - the ViT-B/16 image (B=32) and text (B=256) towers and the ViT-L/14 image
     tower (24 blocks, B=32) through the kernels against the same blocks
     through the plain versions; RN50's image tower (cuDNN, no kernel of the
     port) in bf16 against f32.
   Each kernel's bound is worked out from these shapes: the larger of its
   bytes (inputs read once, outputs written once) at 3.35 TB/s and its
   operations at the H100's peak for their type (989 TFLOP/s bf16 tensor
   cores, 67 TFLOP/s f32).
4. Drives the two main paths through the apps' entry points with random
   weights (seed 0), each with every launch count set to 0 just before it and
   read just after:
   - Tip-Adapter at ViT-B/16: save_features -> eval_clip -> tip_adapter on
     ``synthetic`` (4 classes, a class-grouped cache: K3) and tip_adapter on
     ``synthetic_1k`` (1000 classes, 1 shot: K2). Checks the catalog, the
     records, the launch counts (K5, K6, K3, K2) and the stored features
     against the f32 model on the CPU.
   - CLIP-search at ViT-L/14, full width and depth: save_features ->
     save_image_outs -> image_attention with Hard and with Softmax values on
     ``synthetic_1k`` (8 selection strategies, the config's beta and alpha
     lists). A random text tower scores nearly every image for one class (a
     prediction-sorted cache of one class: K3), so image_attention runs twice
     more over pseudo-labels that scatter (cosines to the class means of the
     stored features: K2 for Hard values, K1 for Softmax). Then the same three
     apps on the 4-class ``synthetic``. Checks the record counts, that
     alpha = 0 reproduces the zero-shot accuracy, the launch counts (K1, K2,
     K3, K4, K5, K6; K4 = 24 x image batches), for three of the runs every
     record's saved predictions against predictions rebuilt from the stored
     arrays and the plain version of the cache logits, and the stored
     ViT-L/14 features and zero-shot scores against the f32 model on the CPU.
5. Prints a JSON line of the kernels of the main paths (K12 runs on neither,
   so it has a line of its own), then as its last line
   ``{"ok": true, "device": {...}}``. Any failure exits non-zero.
"""

from __future__ import annotations

import concurrent.futures
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

KERNEL_SOURCES = ("block_kernels", "cache_kernels", "attention_kernels")
PEAK_BYTES = 3.35e12      # H100 SXM device memory, bytes/s
PEAK_BF16 = 989e12        # dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12          # f32 FLOP/s outside the tensor cores

# bf16 kernel vs bf16 plain version: the same rounding points, other f32
# summation orders. An intermediate (q/k/v, hidden, scores) may round to the
# neighbouring bf16 value, which moves an output of size ~4 by a few bf16 ulps
# (2^-6 each at [4, 8)).
TOL_BLOCK_MAX = 0.125
TOL_BLOCK_MEAN = 2e-3
# Cache sums (<= 16 terms of size <= 1 per class): a weight may round to the
# neighbouring bf16 value when the plain f32 affinity differs in its last bit.
TOL_CACHE_VS_PLAIN = 2e-2
# K3 and K2 add the same bf16 weights (same affinity tiles); only the f32
# summation order differs.
TOL_K3_VS_K2 = 1e-4
# K1: sums of up to 16384 weights <= 1 times values <= 1 (outputs up to ~30);
# same rounding argument as the label kernels, larger sums.
TOL_K1_VS_PLAIN = 3e-2
# Attention outputs are averages of values of size ~1: a probability that
# rounds to the neighbouring bf16 value moves an output by a few bf16 ulps.
TOL_ATTN_MAX = 0.05
TOL_ATTN_MEAN = 1e-3
# CLIP-search predictions, app (kernels) vs plain version: a cache logit that
# differs by one bf16 weight step flips an argmax only at a near tie.
TOL_PRED_AGREE = 0.99
# ... and the comparison means something only if the cache logits decide
# predictions at all: at the largest alpha they must change this share of them.
MIN_PRED_CHANGED = 0.10
# Zero-shot scores are cosines; a bf16 text classifier at cosine 0.9998 of the
# f32 one moves a score by at most sqrt(2 (1 - 0.9998)) = 0.02.
TOL_OUTS_VS_CPU = 0.02


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def versions() -> str:
    import torch

    from summer_clip_torch.ops import _lib

    nvcc = subprocess.run([_lib._nvcc(), "--version"], capture_output=True, text=True)
    nvcc_v = nvcc.stdout.strip().splitlines()[-1] if nvcc.returncode == 0 else "missing"
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "not installed"
    return (f"python {sys.version.split()[0]} | torch {torch.__version__} | "
            f"torch CUDA {torch.version.cuda} | nvcc {nvcc_v} | triton {triton_v}")


def bound(bytes_moved: float, bf16_flops: float, f32_flops: float = 0.0) -> dict:
    """The least time the card could take: bytes at the memory rate against
    operations at the peak rate of their type."""
    by_bytes = bytes_moved / PEAK_BYTES * 1e3
    by_ops = (bf16_flops / PEAK_BF16 + f32_flops / PEAK_F32) * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------- #
def _randn(shape, gen, scale=1.0, dtype=None, device="cuda"):
    import torch

    t = torch.randn(shape, generator=gen) * scale
    return t.to(device=device, dtype=dtype or torch.bfloat16)


def block_params(d: int, gen):
    import torch

    f32 = torch.float32
    return dict(
        ln_w=_randn((d,), gen, 0.1, f32) + 1.0, ln_b=_randn((d,), gen, 0.1, f32),
        in_w=_randn((3 * d, d), gen, d ** -0.5), in_b=_randn((3 * d,), gen, 0.02),
        out_w=_randn((d, d), gen, d ** -0.5), out_b=_randn((d,), gen, 0.02),
        fc_w=_randn((4 * d, d), gen, d ** -0.5), fc_b=_randn((4 * d,), gen, 0.02),
        proj_w=_randn((d, 4 * d), gen, (4 * d) ** -0.5), proj_b=_randn((d,), gen, 0.02))


def check_block_kernels(results: dict) -> None:
    import torch

    from summer_clip_torch.ops import block_kernels as bk

    gen = torch.Generator().manual_seed(0)
    for tower, (b, t, d, heads, causal) in {
            "vit_b16_image": (32, 197, 768, 12, False),
            "vit_b16_text": (256, 77, 512, 8, True),
            "vit_l14_text": (256, 77, 768, 12, True)}.items():
        p = block_params(d, gen)
        x = _randn((b, t, d), gen)
        attn_args = (x, p["ln_w"], p["ln_b"], p["in_w"], p["in_b"], p["out_w"], p["out_b"])
        mlp_args = (x, p["ln_w"], p["ln_b"], p["fc_w"], p["fc_b"], p["proj_w"], p["proj_b"])
        cases = {
            "K5 fused_ln_attn": (
                lambda: bk.fused_ln_attn(*attn_args, num_heads=heads, causal=causal),
                lambda: bk.ln_attn_reference(*attn_args, num_heads=heads, causal=causal)),
            "K6 fused_ln_mlp": (lambda: bk.fused_ln_mlp(*mlp_args),
                                lambda: bk.ln_mlp_reference(*mlp_args)),
        }
        for name, (kern, plain) in cases.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err, mean_err = float(diff.max()), float(diff.mean())
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name} {tower}: non-finite output")
            ms, plain_ms = cuda_time_ms(kern, 20), cuda_time_ms(plain, 20)
            log(f"{name:18s} {tower:14s} B={b} T={t} D={d} heads={heads} causal={causal}: "
                f"max|d|={err:.3e} (tol {TOL_BLOCK_MAX}) mean|d|={mean_err:.3e} "
                f"(tol {TOL_BLOCK_MEAN}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
            if err > TOL_BLOCK_MAX or mean_err > TOL_BLOCK_MEAN:
                raise AssertionError(f"{name} {tower}: kernel disagrees with its plain version")
            m = b * t
            weights = 4 * d * d if name.startswith("K5") else 8 * d * d
            flops = (2 * m * d * 4 * d + 4 * b * heads * t * t * (d // heads)
                     if name.startswith("K5") else 2 * 2 * m * d * 4 * d)
            r = results.setdefault(name, {"max_abs_err": 0.0, "shapes": {}, "library_ms": None})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["shapes"][tower] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                                  **bound(2 * (2 * m * d + weights), flops)}
    torch.cuda.synchronize()


def check_cache_kernels(results: dict) -> None:
    import numpy as np
    import torch

    from summer_clip_torch.methods.tip import beta_alpha_grid
    from summer_clip_torch.ops import cache_kernels as ck

    nt, per_class, c, d = 8192, 16, 1000, 512
    rng = np.random.default_rng(0)

    def unit(n):
        a = rng.standard_normal((n, d)).astype(np.float32)
        return torch.from_numpy(a / np.linalg.norm(a, axis=1, keepdims=True)).cuda()

    f, keys = unit(nt), unit(per_class * c)
    labels = np.repeat(np.arange(c, dtype=np.int32), per_class)        # class-grouped
    betas = torch.from_numpy(beta_alpha_grid((7, 3), (200, 20))[0][::12][:16]).cuda()
    perm = rng.permutation(labels.shape[0])
    keys_sh, labels_sh = keys[torch.from_numpy(perm).cuda()], labels[perm]
    if ck.onehot_k_max(labels, c, d, 2) > 128 or ck.onehot_k_max(labels_sh, c, d, 2) <= 128:
        raise AssertionError("route test: grouped cache must take K3, shuffled K2")

    def plain(k, lab):
        return ck.cache_attention_labels_reference(
            f, k, torch.from_numpy(lab), betas, c, compute_dtype=torch.bfloat16)

    k3 = lambda: ck.cache_attention_onehot(f, keys, labels, betas, c)       # noqa: E731
    k2 = lambda: ck.cache_attention_labels(f, keys_sh, labels_sh, betas, c)  # noqa: E731
    want = plain(keys, labels)
    got3, got2 = k3(), k2()
    got2_grouped = ck.cache_attention_labels(f, keys, labels, betas, c)
    torch.cuda.synchronize()
    e3 = float((got3 - want).abs().max())
    e2 = float((got2 - want).abs().max())
    e32 = float((got3 - got2_grouped).abs().max())
    shape = f"Nt={nt} Nc={per_class * c} D={d} C={c} betas={betas.shape[0]}"
    ms3, ms2 = cuda_time_ms(k3, 3, 1), cuda_time_ms(k2, 3, 1)
    plain_ms = cuda_time_ms(lambda: plain(keys, labels), 2, 1)
    log(f"K3 onehot_grouped   grouped cache  {shape}: max|d| vs plain={e3:.3e} "
        f"(tol {TOL_CACHE_VS_PLAIN}) kernel {ms3:.4f} ms plain {plain_ms:.4f} ms")
    log(f"K2 labels_dense     shuffled cache {shape}: max|d| vs plain={e2:.3e} "
        f"(tol {TOL_CACHE_VS_PLAIN}) kernel {ms2:.4f} ms plain {plain_ms:.4f} ms")
    log(f"K3 == K2 on the grouped cache: max|d|={e32:.3e} (tol {TOL_K3_VS_K2})")
    if not (torch.isfinite(got3).all() and torch.isfinite(got2).all()):
        raise AssertionError("cache kernels: non-finite output")
    if e3 > TOL_CACHE_VS_PLAIN or e2 > TOL_CACHE_VS_PLAIN or e32 > TOL_K3_VS_K2:
        raise AssertionError("cache kernels disagree")
    nc, nb = per_class * c, int(betas.shape[0])
    moved = 2 * (nt + nc) * d + 4 * nc + 4 * nb * nt * c      # bf16 features, labels, f32 out
    affinity = 2 * nt * nc * d
    results["K3 onehot_grouped"] = {
        "max_abs_err": e3, "ms": ms3, "plain_ms": plain_ms, "k3_vs_k2": e32, "library_ms": None,
        # every cache row meets every query once per beta: one exp and one add
        **bound(moved, affinity, 2 * nb * nt * nc)}
    results["K2 labels_dense"] = {
        "max_abs_err": e2, "ms": ms2, "plain_ms": plain_ms, "library_ms": None,
        # the dense w @ one_hot product the kernel computes
        **bound(moved, affinity + nb * 2 * nt * nc * c, nb * nt * nc)}

    # K3 as CLIP-search gives it: D=768, 1000 test rows, a prediction-sorted
    # selection padded with label -1 to a multiple of 1024 rows, the config's 8
    # betas. Once with predictions collapsed onto a few classes (what a random
    # model gives), once spread over 100 classes.
    d, nt = 768, 1000
    f = unit(nt)
    betas8 = torch.tensor([0.1, 1.0, 1.5, 3.5, 5.5, 7.5, 9.5, 11.5], device="cuda")
    shapes = results["K3 onehot_grouped"]["shapes"] = {}
    for case, real in {
            "search_collapsed": np.sort(rng.choice([7, 421, 998], 2000, p=[0.9, 0.07, 0.03])),
            "search_100_classes": np.repeat(np.arange(0, 1000, 10), 6)}.items():
        lab = np.full((-(-real.shape[0] // 1024) * 1024,), -1, np.int32)
        lab[:real.shape[0]] = real
        keys = unit(lab.shape[0])
        if ck.onehot_k_max(lab, c, d, 2) > 128:
            raise AssertionError(f"route test: {case} must take K3")
        kern = lambda: ck.cache_attention_from_labels(f, keys, lab, betas8, c)   # noqa: E731
        ref = lambda: ck.cache_attention_labels_reference(                       # noqa: E731
            f, keys, torch.from_numpy(lab), betas8, c, compute_dtype=torch.bfloat16)
        before = ck.cache_attention_onehot.launches
        got, want = kern(), ref()
        torch.cuda.synchronize()
        if ck.cache_attention_onehot.launches != before + 1:
            raise AssertionError(f"{case}: the label route did not launch K3")
        err = float((got - want).abs().max())
        ms, ref_ms = cuda_time_ms(kern, 5, 1), cuda_time_ms(ref, 5, 1)
        log(f"K3 onehot_grouped   {case:18s} Nt={nt} Nc={lab.shape[0]} ({real.shape[0]} real) "
            f"D={d} C={c} betas=8: max|d| vs plain={err:.3e} (tol {TOL_CACHE_VS_PLAIN}) "
            f"kernel {ms:.4f} ms plain {ref_ms:.4f} ms")
        if not torch.isfinite(got).all() or err > TOL_CACHE_VS_PLAIN:
            raise AssertionError(f"K3 {case}: kernel disagrees with its plain version")
        n_real = real.shape[0]
        shapes[case] = {"ms": ms, "plain_ms": ref_ms, "max_abs_err": err,
                        **bound(2 * (nt + n_real) * d + 4 * n_real + 4 * 8 * nt * c,
                                2 * nt * n_real * d, 2 * 8 * nt * n_real)}
        results["K3 onehot_grouped"]["max_abs_err"] = max(
            results["K3 onehot_grouped"]["max_abs_err"], err)
    torch.cuda.synchronize()


def check_attention_kernels(results: dict) -> None:
    import torch
    import torch.nn.functional as F

    from summer_clip_torch.ops import attention as at

    gen = torch.Generator().manual_seed(2)

    def run(name, shape_name, kern, plain, library, b, h, t):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err, mean_err = float(diff.max()), float(diff.mean())
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name} {shape_name}: non-finite output")
        ms, plain_ms, lib_ms = cuda_time_ms(kern, 20), cuda_time_ms(plain, 20), cuda_time_ms(library, 20)
        log(f"{name:25s} {shape_name:16s}: max|d|={err:.3e} (tol {TOL_ATTN_MAX}) "
            f"mean|d|={mean_err:.3e} (tol {TOL_ATTN_MEAN}) kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms SDPA {lib_ms:.4f} ms")
        if err > TOL_ATTN_MAX or mean_err > TOL_ATTN_MEAN:
            raise AssertionError(f"{name} {shape_name}: kernel disagrees with its plain version")
        r = results.setdefault(name, {"max_abs_err": 0.0, "shapes": {}})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["shapes"][shape_name] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "max_abs_err": err,
            **bound(4 * b * h * t * 64 * 2, 4 * b * h * t * t * 64)}

    for shape_name, (b, t, d, heads, causal) in {
            "vit_l14_image": (32, 257, 1024, 16, False),
            "text_causal": (256, 77, 512, 8, True)}.items():
        # q, k, v as the tower has them: views of one fused projection
        q, k, v = _randn((b, t, 3 * d), gen).split(d, dim=-1)

        def heads_view(x):
            return x.view(b, t, heads, d // heads).transpose(1, 2)

        run("K4 short_attention_packed", shape_name,
            lambda: at.short_attention_packed(q, k, v, num_heads=heads, causal=causal),
            lambda: at.short_attention_packed_reference(q, k, v, num_heads=heads, causal=causal),
            lambda: F.scaled_dot_product_attention(heads_view(q), heads_view(k), heads_view(v),
                                                   is_causal=causal),
            b, heads, t)
    q, k, v = (_randn((512, 257, 64), gen) for _ in range(3))
    run("K12 short_attention", "vit_l14_image", lambda: at.short_attention(q, k, v),
        lambda: at.mha_reference(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v), 512, 1, 257)
    torch.cuda.synchronize()


def check_dense_cache_kernel(results: dict) -> None:
    import numpy as np
    import torch

    from summer_clip_torch.ops import cache_kernels as ck

    rng = np.random.default_rng(1)
    d, c, nb = 768, 1000, 8
    betas = torch.tensor([0.1, 1.0, 1.5, 3.5, 5.5, 7.5, 9.5, 11.5], device="cuda")

    def unit(n):
        a = rng.standard_normal((n, d)).astype(np.float32)
        return torch.from_numpy(a / np.linalg.norm(a, axis=1, keepdims=True)).cuda()

    r = results.setdefault("K1 cache_dense", {"max_abs_err": 0.0, "shapes": {}, "library_ms": None})
    for shape_name, (nt, nc) in {"clip_search": (8192, 16384), "pipeline": (1000, 2048)}.items():
        f, keys = unit(nt), unit(nc)
        outs = torch.from_numpy(rng.standard_normal((nc, c)).astype(np.float32)).cuda() * 0.05
        labels = outs.argmax(1)
        for vname, v in (("bf16 softmax values", torch.softmax(100.0 * outs, 1).to(torch.bfloat16)),
                         ("int8 one-hot values",
                          torch.nn.functional.one_hot(labels, c).to(torch.int8))):
            kern = lambda: ck.cache_attention(f, keys, v, betas)             # noqa: E731
            plain = lambda: ck.cache_attention_dense_reference(              # noqa: E731
                f, keys, v, betas, compute_dtype=torch.bfloat16)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not torch.isfinite(got).all():
                raise AssertionError(f"K1 {shape_name} {vname}: non-finite output")
            ms, plain_ms = cuda_time_ms(kern, 3, 1), cuda_time_ms(plain, 2, 1)
            log(f"K1 cache_dense     {shape_name:11s} Nt={nt} Nc={nc} D={d} C={c} betas={nb} "
                f"{vname}: max|d| vs plain={err:.3e} (tol {TOL_K1_VS_PLAIN}) kernel {ms:.4f} ms "
                f"plain {plain_ms:.4f} ms")
            if err > TOL_K1_VS_PLAIN:
                raise AssertionError(f"K1 {shape_name} {vname}: kernel disagrees with plain")
            r["max_abs_err"] = max(r["max_abs_err"], err)
            vbytes = v.element_size()
            r["shapes"][f"{shape_name} {vname.split()[0]}"] = {
                "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                **bound(2 * (nt + nc) * d + vbytes * nc * c + 4 * nb * nt * c,
                        2 * nt * nc * d + nb * 2 * nt * nc * c, nb * nt * nc)}
        k2 = ck.cache_attention_labels(f, keys, labels.cpu().numpy(), betas, c)
        torch.cuda.synchronize()
        e12 = float((got - k2).abs().max())
        log(f"K1 (int8 one-hots) == K2 on the same labels, {shape_name}: max|d|={e12:.3e} "
            f"(tol {TOL_K3_VS_K2})")
        if e12 > TOL_K3_VS_K2:
            raise AssertionError("K1 with one-hot values disagrees with K2")
    torch.cuda.synchronize()


def _plain_blocks(transformer, x, causal: bool = False):
    """The tower's residual blocks through the plain versions (measurement
    only). They compute what either route of a block computes."""
    from summer_clip_torch.ops import block_kernels as bk

    for blk in transformer.resblocks:
        a, m = blk.attn, blk.mlp
        x = bk.ln_attn_reference(x, blk.ln_1.weight, blk.ln_1.bias, a.in_proj_weight,
                                 a.in_proj_bias, a.out_proj.weight, a.out_proj.bias,
                                 num_heads=a.num_heads, causal=causal)
        x = bk.ln_mlp_reference(x, blk.ln_2.weight, blk.ln_2.bias, m.c_fc.weight, m.c_fc.bias,
                                m.c_proj.weight, m.c_proj.bias)
    return x


def time_towers(results: dict) -> None:
    """Towers at the main paths' batches: every block through the kernels
    against the same blocks through the plain versions. ViT-B/16 image and
    text (K5 + K6); the ViT-L/14 image tower's 24 blocks (K4 + cuBLAS)."""
    import torch

    from summer_clip_torch.models.clip.configs import CLIP_CONFIGS
    from summer_clip_torch.models.clip.modeling import Transformer

    gen = torch.Generator().manual_seed(1)

    def tower(width, layers, heads):
        # only the blocks are timed, so only they are built (the CLIP class's
        # init scales: fan-in-scaled weights, zero biases)
        mod = Transformer(width, layers, heads)
        with torch.no_grad():
            for name, p in mod.named_parameters():
                if p.dim() == 2:
                    p.copy_(torch.randn(p.shape, generator=gen) * p.shape[1] ** -0.5)
                elif "ln_" not in name:
                    p.zero_()
                if "ln_" not in name:
                    p.data = p.data.to(torch.bfloat16)
        return mod.requires_grad_(False).to("cuda").eval()

    b16, l14 = CLIP_CONFIGS["ViT-B/16"], CLIP_CONFIGS["ViT-L/14"]
    for name, (cfg_t, b, t, causal) in {
            "ViT-B/16 image B=32": ((b16.vision_width, b16.vision_layers, b16.vision_heads),
                                    32, 197, False),
            "ViT-B/16 text B=256": ((b16.text_width, b16.text_layers, b16.text_heads),
                                    256, 77, True),
            "ViT-L/14 image B=32": ((l14.vision_width, l14.vision_layers, l14.vision_heads),
                                    32, 257, False)}.items():
        mod = tower(*cfg_t)
        x = _randn((b, t, cfg_t[0]), gen)
        with torch.inference_mode():
            got, want = mod(x, causal), _plain_blocks(mod, x, causal)
            cos = float(torch.nn.functional.cosine_similarity(
                got.float().flatten(1), want.float().flatten(1), dim=1).min())
            ms = cuda_time_ms(lambda: mod(x, causal), 5)
            plain_ms = cuda_time_ms(lambda: _plain_blocks(mod, x, causal), 5)
        log(f"tower {name:20s} {cfg_t[1]} blocks: kernels {ms:.3f} ms ({b / ms * 1e3:.1f} rows/s) "
            f"plain {plain_ms:.3f} ms ({b / plain_ms * 1e3:.1f} rows/s), min cosine vs plain "
            f"{cos:.6f} (tol >= 0.999)")
        if cos < 0.999:
            raise AssertionError(f"tower {name}: kernels disagree with the plain blocks")
        results[f"tower {name}"] = {"ms": ms, "plain_ms": plain_ms}
        del mod
    torch.cuda.synchronize()


def check_resnet_tower(results: dict) -> None:
    """RN50's image tower (stock cuDNN convolutions, no hand-written kernel; the
    default ``clip`` of ``image_attention.yaml``) in bf16 against the same
    random weights in f32, both on the card, and its time at the extract batch."""
    import torch

    from summer_clip_torch.models.clip import build_clip

    model, cfg = build_clip("RN50", torch.Generator().manual_seed(0), device="cuda")
    images = _randn((32, cfg.image_resolution, cfg.image_resolution, 3),
                    torch.Generator().manual_seed(3), dtype=torch.float32)
    with torch.inference_mode():
        want = model.encode_image(images)
        model.to_compute(torch.bfloat16)
        got = model.encode_image(images)
        cos = float(torch.nn.functional.cosine_similarity(got.float(), want, dim=-1).min())
        ms = cuda_time_ms(lambda: model.encode_image(images), 30, 5)
    log(f"tower RN50 image B=32 (cuDNN, no kernel of the port): bf16 {ms:.3f} ms "
        f"({32 / ms * 1e3:.1f} img/s), min cosine vs f32 {cos:.6f} (tol >= 0.99)")
    if tuple(got.shape) != (32, cfg.embed_dim) or not torch.isfinite(got.float()).all() \
            or cos < 0.99:
        raise AssertionError("RN50 tower: bf16 features disagree with f32")
    results["tower RN50 image B=32"] = {"ms": ms}


# --------------------------------------------------------------------------- #
# phase 4: the main paths through the port's entry points
# --------------------------------------------------------------------------- #
def launch_counters():
    from summer_clip_torch.ops import attention as at
    from summer_clip_torch.ops import block_kernels as bk
    from summer_clip_torch.ops import cache_kernels as ck

    return {"K1 cache_dense": ck.cache_attention,
            "K2 labels_dense": ck.cache_attention_labels,
            "K3 onehot_grouped": ck.cache_attention_onehot,
            "K4 short_attention_packed": at.short_attention_packed,
            "K5 fused_ln_attn": bk.fused_ln_attn, "K6 fused_ln_mlp": bk.fused_ln_mlp,
            "K12 short_attention": at.short_attention}


def counted(path_name: str, needed, drive):
    """Set every launch count to 0, drive one main path, read the counts, and
    fail if a kernel of that path never launched."""
    import torch

    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = drive()
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"phase pipeline {path_name}: {time.perf_counter() - t0:.2f} s, per app "
        + json.dumps({k: round(v, 3) for k, v in out["times_s"].items()}))
    log(f"pipeline {path_name} launches: {json.dumps(launches)}")
    missing = [k for k in needed if launches[k] <= 0]
    if missing:
        raise AssertionError(f"main path {path_name} did not launch {missing}")
    return out, launches


def run_apps(runs, work: Path) -> dict:
    """Each (name, app function, argv) in its own working directory."""
    import os

    times = {}
    cwd = os.getcwd()
    try:
        for name, fn, argv in runs:
            sub = work / name
            sub.mkdir(parents=True)
            os.chdir(sub)
            t0 = time.perf_counter()
            fn(argv=argv)
            times[name] = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    return times


def records(run_root: Path, kind: str) -> list:
    out = []
    for p in sorted(run_root.rglob("records.jsonl")):
        out.extend(r for r in map(json.loads, p.read_text().splitlines())
                   if r.get("type") == kind)
    return out


def run_pipeline(work: Path, clip: str = "vit_b16", batch: int = 32,
                 search_step: str = "[32,4]") -> dict:
    """save_features -> eval_clip -> tip_adapter (synthetic: K3) and
    tip_adapter (synthetic_1k, 1 shot: K2), each app in its own directory."""
    import numpy as np

    from summer_clip_torch.store import FeatureStore
    from summer_clip_torch.apps import eval_clip, save_features, tip_adapter

    store = work / "features"
    tag = "ViT-B16"
    common = [f"clip={clip}"]
    tip = ["root_path=''", f"data.batch_size={batch}", f"search_step={search_step}",
           "search_scale=[7,3]"]
    times = run_apps([
        ("save_features", save_features.run, common + [
            "dataset_name=synthetic", "dataset@train_dataset=synthetic_train",
            "dataset@test_dataset=synthetic_test", f"data.batch_size={batch}",
            f"store.root={store}"]),
        ("eval_clip", eval_clip.run, common + [
            "dataset_name=synthetic", "dataset=synthetic_test", f"store.root={store}",
            f"eval.features_key=synthetic_test-{tag}"]),
        ("tip_adapter", tip_adapter.run,
         common + ["dataset=synthetic", "shots=2", "augment_epoch=2", *tip]),
        ("tip_adapter_1k", tip_adapter.run,
         common + ["dataset=synthetic_1k", "shots=1", "augment_epoch=1", *tip]),
    ], work)

    fs = FeatureStore(store)
    for split in ("train", "test"):
        key = f"synthetic_{split}-{tag}"
        if key not in fs:
            raise AssertionError(f"catalog key {key} missing")
        feats = fs.load(key, "features")
        if feats.ndim != 2 or not np.isfinite(feats).all():
            raise AssertionError(f"{key}: bad features {feats.shape}")
    for sub, kinds in (("eval_clip", ("zero_shot",)),
                       ("tip_adapter", ("zero_shot", "tip_result", "tip_searched")),
                       ("tip_adapter_1k", ("zero_shot", "tip_result", "tip_searched"))):
        for kind in kinds:
            recs = records(work / sub, kind)
            if not recs or not all(0.0 <= r["acc1"] <= 100.0 for r in recs):
                raise AssertionError(f"{sub}: record {kind} missing or out of range")
    return {"times_s": times, "store": store}


def check_against_cpu(store: Path, model_name: str, n: int, outs: bool = False):
    """What the card's bf16 kernel route stored for ``synthetic`` against the
    same random model in f32 on the CPU (plain versions): the first ``n`` test
    features (min cosine), and with ``outs`` the zero-shot scores that
    ``save_image_outs`` stored for the train split against the stored features
    times the CPU model's text classifier (max |difference| of cosines)."""
    import numpy as np
    import torch

    from summer_clip_torch.data.datasets import SyntheticDataset
    from summer_clip_torch.methods.zeroshot import clip_logits, zeroshot_classifier
    from summer_clip_torch.models.clip import build_clip
    from summer_clip_torch.store import FeatureStore

    model, cfg = build_clip(model_name, torch.Generator().manual_seed(0))
    ds, fs, tag = SyntheticDataset(), FeatureStore(store), model_name.replace("/", "")
    images = np.stack([SyntheticDataset.render(i.impath, cfg.image_resolution)
                       for i in ds.test[:n]])
    with torch.inference_mode():
        ref = model.encode_image(torch.from_numpy(images)).numpy()
        got = fs.load(f"synthetic_test-{tag}", "features")[:n]
        cos = (got * ref).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1))
        if not outs:
            return float(cos.min()), None
        classifier = zeroshot_classifier(model.encode_text, ds.classnames, ds.template,
                                         chunk_size=len(ds.classnames))
        feats = torch.from_numpy(np.array(fs.load(f"synthetic_train-{tag}", "features")))
        want = clip_logits(feats, classifier, scale=1.0).numpy()
    stored = fs.load(f"synthetic_train_outs-{tag}", "outs")
    return float(cos.min()), float(np.abs(stored - want).max())


def write_prototype_outs(store: Path, ds: str, tag: str) -> int:
    """Pseudo-label scores that do not collapse: the cosine of each stored
    train feature to every class's mean train feature, saved as ``outs`` under
    ``{ds}_train_protos-{tag}``. A random text tower scores nearly every image
    for one class, so ``save_image_outs`` alone gives CLIP-search a cache of
    one class; with these its predicted classes scatter, as a trained model's
    do. Returns the number of distinct predicted classes."""
    import numpy as np
    import torch

    from summer_clip_torch.store import FeatureStore

    fs = FeatureStore(store)
    feats = torch.from_numpy(np.array(fs.load(f"{ds}_train-{tag}", "features"))).cuda()
    labels = torch.from_numpy(np.array(fs.load(f"{ds}_train-{tag}", "labels"))).long().cuda()
    feats = feats / feats.norm(dim=1, keepdim=True)
    protos = torch.zeros(int(labels.max()) + 1, feats.shape[1], device="cuda")
    protos.index_add_(0, labels, feats)
    protos = protos / protos.norm(dim=1, keepdim=True)
    outs = (feats @ protos.t()).cpu().numpy().astype(np.float32)
    fs.save(f"{ds}_train_protos-{tag}", outs=outs)
    return int(np.unique(outs.argmax(1)).shape[0])


def check_search_predictions(run_root: Path, store: Path, ds: str, tag: str,
                             outs_key: str) -> dict:
    """Every ``searcher_result`` record of one image_attention run, made with
    ``run_saves.save_logits``, ``save_cache_inds`` and ``save_preds``: the
    predictions the app saved (its kernels, its resident sorted cache, its
    gathers and label tables) against predictions rebuilt here from the stored
    arrays, the saved selection and the plain dense version of the cache
    logits. Returns the least share of test rows on which the two agree, the
    share of rows whose prediction the cache changed at the largest alpha, and
    the number of records compared."""
    import numpy as np
    import torch

    from summer_clip_torch.core import config as C
    from summer_clip_torch.ops import cache_kernels as ck
    from summer_clip_torch.store import FeatureStore

    fs = FeatureStore(store)

    def unit(key):
        x = torch.from_numpy(np.array(fs.load(key, "features"), np.float32)).cuda()
        return x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)

    test, cache = unit(f"{ds}_test-{tag}"), unit(f"{ds}_train-{tag}")
    outs = np.array(fs.load(outs_key, "outs"), np.float32)
    rec_file, = run_root.rglob("records.jsonl")
    run_dir = rec_file.parent
    recs = [json.loads(line) for line in rec_file.read_text().splitlines()]
    zero, = (r for r in recs if r.get("type") == "zero_shot")
    clip = torch.from_numpy(np.load(run_dir / zero["logits_path"])).cuda()
    zero_preds = clip.argmax(1)
    top_alpha = max(r["alpha"] for r in recs if r.get("type") == "searcher_result")

    worst, changed, n = 1.0, 0.0, 0
    inds, plain = None, {}
    for r in recs:
        if r.get("type") == "cache_info":
            inds, plain = np.load(run_dir / r["cache_inds_path"]), {}
        if r.get("type") != "searcher_result":
            continue
        vkey = json.dumps(r["cache_value_strategy"], sort_keys=True)
        beta = float(r["cache_weights_strategy"]["beta"])
        if (vkey, beta) not in plain:
            values = C.instantiate(r["cache_value_strategy"]).transform(outs[inds])
            plain[vkey, beta] = ck.cache_attention_dense_reference(
                test, cache[torch.from_numpy(inds).cuda()], torch.from_numpy(values).cuda(),
                torch.tensor([beta]), compute_dtype=torch.bfloat16)[0]
        want = (clip + r["alpha"] * plain[vkey, beta]).argmax(1)
        got = torch.from_numpy(np.load(run_dir / r["preds_path"])).cuda()
        worst = min(worst, float((got == want).float().mean()))
        if r["alpha"] == top_alpha:
            changed = max(changed, float((want != zero_preds).float().mean()))
        n += 1
    return {"agree_min": worst, "changed_max": changed, "records": n}


def run_clip_search(work: Path) -> dict:
    """CLIP-search at ViT-L/14 on ``synthetic_1k``: save_features ->
    save_image_outs -> image_attention with Hard, then Softmax values; then
    image_attention twice more over prototype pseudo-labels
    (:func:`write_prototype_outs`), whose predictions scatter; then the chain
    on the 4-class ``synthetic`` with Hard values. Three of the runs save their
    predictions and are held against the plain version record by record."""
    from summer_clip_torch.apps import image_attention, save_features, save_image_outs

    store = work / "features"
    tag = "ViT-L14"
    common = ["clip=vit_l14", f"store.root={store}"]
    saves = ["run_saves.save_logits=true", "run_saves.save_cache_inds=true",
             "run_saves.save_preds=true"]
    scattered = {}

    def search(ds: str, name: str, outs_key: str, value: str, extra=()):
        return (f"image_attention_{ds}_{name}", image_attention.run,
                [f"dataset_name={ds}", "dataset=synthetic_test", f"dataset.dataset={ds}",
                 "dataset.load_images=false", "dataset@cache.dataset=synthetic_train",
                 f"cache.dataset.dataset={ds}", "cache.dataset.load_images=false",
                 f"data.features_key={ds}_test-{tag}", f"cache.features_key={ds}_train-{tag}",
                 f"cache.outs_key={outs_key}", f"cache_value_strategy={value}", *extra])

    def chain(ds: str, searches) -> list:
        runs = [
            (f"save_features_{ds}", save_features.run,
             [f"dataset_name={ds}", "dataset@train_dataset=synthetic_train",
              "dataset@test_dataset=synthetic_test", f"train_dataset.dataset={ds}",
              f"test_dataset.dataset={ds}", "save_train_outs=false"]),
            (f"save_image_outs_{ds}", save_image_outs.run,
             [f"dataset_name={ds}", "dataset=synthetic_train", f"dataset.dataset={ds}",
              "dataset.load_images=false", f"data.features_key={ds}_train-{tag}",
              f"data.output_key={ds}_train_outs-{tag}"]),
            *searches]
        return [(name, fn, common + argv) for name, fn, argv in runs]

    outs_1k, protos_1k = f"synthetic_1k_train_outs-{tag}", f"synthetic_1k_train_protos-{tag}"
    times = run_apps(
        chain("synthetic_1k", [
            search("synthetic_1k", "hard_cache", outs_1k, "hard_cache", saves),
            search("synthetic_1k", "softmax_cache", outs_1k, "softmax_cache"),
            ("prototype_outs", lambda argv: scattered.update(
                classes=write_prototype_outs(store, "synthetic_1k", tag)), []),
            search("synthetic_1k", "protos_hard_cache", protos_1k, "hard_cache", saves),
            search("synthetic_1k", "protos_softmax_cache", protos_1k, "softmax_cache", saves)])
        + chain("synthetic", [search("synthetic", "hard_cache", f"synthetic_train_outs-{tag}",
                                     "hard_cache")]), work)
    log(f"prototype pseudo-labels of synthetic_1k: {scattered['classes']} distinct predicted "
        f"classes of 1000")
    if scattered["classes"] < 500:
        raise AssertionError("prototype pseudo-labels do not scatter")

    # 7 strategies x 6 cache sizes + all_logits, x value settings x 8 betas x 7 alphas
    selections, betas, alphas = 7 * 6 + 1, 8, 7
    for sub, n_values, outs_key in (
            ("image_attention_synthetic_1k_hard_cache", 1, outs_1k),
            ("image_attention_synthetic_1k_softmax_cache", 3, None),
            ("image_attention_synthetic_1k_protos_hard_cache", 1, protos_1k),
            ("image_attention_synthetic_1k_protos_softmax_cache", 3, protos_1k),
            ("image_attention_synthetic_hard_cache", 1, None)):
        recs = records(work / sub, "searcher_result")
        want = selections * n_values * betas * alphas
        if len(recs) != want:
            raise AssertionError(f"{sub}: {len(recs)} searcher_result records, expected {want}")
        zero = records(work / sub, "zero_shot")
        if len(zero) != 1:
            raise AssertionError(f"{sub}: expected one zero_shot record")
        for r in recs:
            if not (0.0 <= r["acc1"] <= r["acc5"] <= 100.0):
                raise AssertionError(f"{sub}: accuracies out of range in {r}")
            if r["alpha"] == 0.0 and abs(r["acc1"] - zero[0]["acc1"]) > 1e-6:
                raise AssertionError(f"{sub}: alpha = 0 does not reproduce zero-shot: {r}")
        if len(records(work / sub, "cache_info")) != selections:
            raise AssertionError(f"{sub}: expected {selections} cache_info records")
        log(f"{sub}: {len(recs)} searcher_result records, "
            f"{times[sub] / (selections * n_values) * 1e3:.1f} ms of wall clock per "
            f"(selection, value) combination of {betas} betas x {alphas} alphas, zero-shot acc1 "
            f"{zero[0]['acc1']:.2f}, best acc1 {max(r['acc1'] for r in recs):.2f}")
        if outs_key is None:
            continue
        t0 = time.perf_counter()
        held = check_search_predictions(work / sub, store, "synthetic_1k", tag, outs_key)
        log(f"{sub}: saved predictions of {held['records']} records vs the plain version on the "
            f"stored arrays: least agreement {held['agree_min']:.4f} of rows (tol >= "
            f"{TOL_PRED_AGREE}), the cache changed up to {held['changed_max']:.4f} of the "
            f"zero-shot predictions at the largest alpha (scattered pseudo-labels: must be >= "
            f"{MIN_PRED_CHANGED}), "
            f"{time.perf_counter() - t0:.2f} s")
        if held["records"] != want or held["agree_min"] < TOL_PRED_AGREE:
            raise AssertionError(f"{sub}: the app's predictions disagree with the plain version")
        # a cache whose pseudo-labels fell onto one class adds to one column only
        if outs_key == protos_1k and held["changed_max"] < MIN_PRED_CHANGED:
            raise AssertionError(f"{sub}: the cache logits change no prediction, so the "
                                 f"comparison shows nothing")
    return {"times_s": times, "store": store}


KERNELS = {
    # name: (source, TPU kernel it replaces, shape whose times stand in the kernels line)
    "K1 cache_dense": ("summer_clip_torch/csrc/cache_kernels.cu",
                       "summer_clip_tpu/ops/cache_kernels.py:103", "clip_search bf16"),
    "K2 labels_dense": ("summer_clip_torch/csrc/cache_kernels.cu",
                        "summer_clip_tpu/ops/cache_kernels.py:509", None),
    "K3 onehot_grouped": ("summer_clip_torch/csrc/cache_kernels.cu",
                          "summer_clip_tpu/ops/cache_kernels.py:394", None),
    "K4 short_attention_packed": ("summer_clip_torch/csrc/attention_kernels.cu",
                                  "summer_clip_tpu/ops/attention.py:248", "vit_l14_image"),
    "K5 fused_ln_attn": ("summer_clip_torch/csrc/block_kernels.cu",
                         "summer_clip_tpu/ops/block_kernels.py:255", "vit_b16_image"),
    "K6 fused_ln_mlp": ("summer_clip_torch/csrc/block_kernels.cu",
                        "summer_clip_tpu/ops/block_kernels.py:75", "vit_b16_image"),
    "K12 short_attention": ("summer_clip_torch/csrc/attention_kernels.cu",
                            "summer_clip_tpu/ops/attention.py:195", "vit_l14_image"),
}
TIP_PATH = ("K5 fused_ln_attn", "K6 fused_ln_mlp", "K3 onehot_grouped", "K2 labels_dense")
SEARCH_PATH = ("K1 cache_dense", "K2 labels_dense", "K3 onehot_grouped",
               "K4 short_attention_packed", "K5 fused_ln_attn", "K6 fused_ln_mlp")


def kernel_entry(name: str, results: dict, by_path: dict) -> dict:
    """``launches`` is the count over both main paths; ``launches_by_path``
    gives each path's own."""
    src, replaces, shape = KERNELS[name]
    r = results[name]
    at_shape = {**r, **r["shapes"][shape]} if shape else r
    return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"],
            **{k: at_shape[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs only on a "
              "CUDA card", file=sys.stderr)
        return 2
    card = card_line()
    log(f"card: {card}")
    log(versions())

    from summer_clip_torch.ops import _lib

    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 products stay f32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:   # one nvcc each
        list(pool.map(lambda name: _lib.build(name, verbose=True), KERNEL_SOURCES))
    log(f"phase build: {time.perf_counter() - t0:.2f} s")

    results: dict = {}
    t0 = time.perf_counter()
    check_block_kernels(results)
    check_attention_kernels(results)
    check_cache_kernels(results)
    check_dense_cache_kernel(results)
    time_towers(results)
    check_resnet_tower(results)
    log(f"phase kernels: {time.perf_counter() - t0:.2f} s")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        pipe, tip_launches = counted("tip_adapter ViT-B/16", TIP_PATH,
                                     lambda: run_pipeline(Path(tmp) / "tip"))
        cos, _ = check_against_cpu(pipe["store"], "ViT-B/16", n=4)
        log(f"stored ViT-B/16 features vs f32 CPU model: min cosine {cos:.6f} (tol >= 0.99)")
        if cos < 0.99:
            raise AssertionError("stored ViT-B/16 features disagree with the f32 model")

        search, search_launches = counted("clip_search ViT-L/14", SEARCH_PATH,
                                          lambda: run_clip_search(Path(tmp) / "search"))
        # synthetic_1k: 2000 + 1000 images, synthetic: 32 + 16, in batches of 32
        batches = -(-2000 // 32) + -(-1000 // 32) + 1 + 1
        if search_launches["K4 short_attention_packed"] != 24 * batches:
            raise AssertionError(f"K4 launched {search_launches['K4 short_attention_packed']} "
                                 f"times, expected 24 x {batches} image batches")
        t0 = time.perf_counter()
        cos, outs_err = check_against_cpu(search["store"], "ViT-L/14", n=2, outs=True)
        log(f"stored ViT-L/14 features vs f32 CPU model: min cosine {cos:.6f} (tol >= 0.99); "
            f"stored zero-shot scores vs the f32 CPU text classifier: max|d| {outs_err:.3e} "
            f"(tol {TOL_OUTS_VS_CPU}), {time.perf_counter() - t0:.2f} s")
        if cos < 0.99 or outs_err > TOL_OUTS_VS_CPU:
            raise AssertionError("stored ViT-L/14 features or scores disagree with the f32 model")

    on_path = [n for n in KERNELS if n in TIP_PATH or n in SEARCH_PATH]
    by_path = {n: {"tip_adapter": tip_launches[n], "clip_search": search_launches[n]}
               for n in KERNELS}
    kernels = [kernel_entry(n, results, by_path[n]) for n in on_path]
    off_path = [kernel_entry(n, results, by_path[n]) for n in KERNELS if n not in on_path]
    log(f"card: {card}")
    # ported kernels that neither main path runs: checked and timed above, listed apart
    print(json.dumps({"kernels_off_the_main_paths": off_path}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
