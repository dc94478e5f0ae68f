#!/usr/bin/env python3
"""Run the PyTorch port (``summer_clip_torch``) on one CUDA card, end to end.

    python3 chip_smoke.py

1. Refuses to run without CUDA. Prints the card (``nvidia-smi`` name and power
   limit) and the torch, CUDA, nvcc and Triton versions.
2. Builds every kernel of the main path from ``summer_clip_torch/csrc`` with
   nvcc (``-Xptxas -v`` report printed).
3. Holds each kernel against its plain PyTorch version on the card at the
   shapes of the main path, with the tolerances below, and times both with
   CUDA events:
   - K5 fused_ln_attn and K6 fused_ln_mlp at the ViT-B/16 image tower
     (B=32, T=197, D=768, 12 heads) and the text tower (B=256, T=77, D=512,
     8 heads, causal);
   - K3 onehot_grouped on a class-grouped Tip cache (Nt=8192, Nc=16*1000,
     D=512, C=1000, 16 betas of the Tip grid) and K2 labels_dense on the same
     cache with its rows shuffled; K3 == K2 on the grouped cache;
   - the ViT-B/16 image (B=32) and text (B=256) towers, 12 blocks through
     the kernels against the same blocks through the plain versions.
4. Sets every launch count to 0, then drives the port's apps at ViT-B/16 with
   random weights: save_features -> eval_clip -> tip_adapter on ``synthetic``
   (4 classes, a class-grouped cache: K3) and tip_adapter on ``synthetic_1k``
   (1000 classes, 1 shot: K2). Checks the catalog, the records, the launch
   counts and the stored features against the f32 model on the CPU.
5. Prints a JSON line of the kernels, then as its last line
   ``{"ok": true, "device": {...}}``. Any failure exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
            "vit_b16_text": (256, 77, 512, 8, True)}.items():
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
            r = results.setdefault(name, {"max_abs_err": 0.0, "shapes": {}})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["shapes"][tower] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err}
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
    results["K3 onehot_grouped"] = {"max_abs_err": e3, "ms": ms3, "plain_ms": plain_ms,
                                    "k3_vs_k2": e32}
    results["K2 labels_dense"] = {"max_abs_err": e2, "ms": ms2, "plain_ms": plain_ms}
    torch.cuda.synchronize()


def _plain_blocks(transformer, x, causal: bool = False):
    """The tower's residual blocks through the plain versions (measurement only)."""
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
    """ViT-B/16 towers at the main path's batches: all 12 blocks through the
    kernels against the same blocks through the plain versions."""
    import torch

    from summer_clip_torch.models.clip import build_clip

    model, cfg = build_clip("ViT-B/16", torch.Generator().manual_seed(0),
                            dtype=torch.bfloat16, device="cuda")
    gen = torch.Generator().manual_seed(1)
    for tower, (mod, b, t, d, causal) in {
            "image B=32": (model.visual.transformer, 32, 197, cfg.vision_width, False),
            "text B=256": (model.transformer, 256, 77, cfg.text_width, True)}.items():
        x = _randn((b, t, d), gen)
        with torch.inference_mode():
            ms = cuda_time_ms(lambda: mod(x, causal), 5)
            plain_ms = cuda_time_ms(lambda: _plain_blocks(mod, x, causal), 5)
        log(f"tower {tower:10s} 12 blocks: kernels {ms:.3f} ms ({b / ms * 1e3:.1f} rows/s) "
            f"plain {plain_ms:.3f} ms ({b / plain_ms * 1e3:.1f} rows/s)")
        results[f"tower {tower}"] = {"ms": ms, "plain_ms": plain_ms}
    torch.cuda.synchronize()


# --------------------------------------------------------------------------- #
# phase 4: the main path through the port's entry points
# --------------------------------------------------------------------------- #
def launch_counters():
    from summer_clip_torch.ops import block_kernels as bk
    from summer_clip_torch.ops import cache_kernels as ck

    return {"K5 fused_ln_attn": bk.fused_ln_attn, "K6 fused_ln_mlp": bk.fused_ln_mlp,
            "K3 onehot_grouped": ck.cache_attention_onehot,
            "K2 labels_dense": ck.cache_attention_labels}


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
    import os

    import numpy as np

    from summer_clip_torch.store import FeatureStore
    from summer_clip_torch.apps import eval_clip, save_features, tip_adapter

    store = work / "features"
    common = [f"clip={clip}"]
    runs = [
        ("save_features", save_features.run,
         ["dataset_name=synthetic", "dataset@train_dataset=synthetic_train",
          "dataset@test_dataset=synthetic_test", f"data.batch_size={batch}",
          f"store.root={store}"]),
        ("eval_clip", eval_clip.run,
         ["dataset_name=synthetic", "dataset=synthetic_test", f"store.root={store}"]),
        ("tip_adapter", tip_adapter.run,
         ["dataset=synthetic", "root_path=''", "shots=2", "augment_epoch=2",
          f"data.batch_size={batch}", f"search_step={search_step}", "search_scale=[7,3]"]),
        ("tip_adapter_1k", tip_adapter.run,
         ["dataset=synthetic_1k", "root_path=''", "shots=1", "augment_epoch=1",
          f"data.batch_size={batch}", f"search_step={search_step}", "search_scale=[7,3]"]),
    ]
    times = {}
    cwd = os.getcwd()
    tag = None
    try:
        for name, fn, argv in runs:
            sub = work / name
            sub.mkdir(parents=True)
            os.chdir(sub)
            if name == "eval_clip":
                argv = argv + [f"eval.features_key=synthetic_test-{tag}"]
            t0 = time.perf_counter()
            fn(argv=common + argv)
            times[name] = time.perf_counter() - t0
            if name == "save_features":
                cat = json.loads((store / "catalog.json").read_text())
                tag = next(k for k in cat if k.startswith("synthetic_test-")).split("-", 1)[1]
    finally:
        os.chdir(cwd)

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
    return {"times_s": times, "store": store, "tag": tag}


def check_features_against_cpu(store: Path, tag: str, n: int = 4) -> float:
    """Stored ViT-B/16 test features (bf16 kernels on the card) against the same
    random model in f32 on the CPU (plain versions), cosine similarity."""
    import numpy as np
    import torch

    from summer_clip_torch.data.datasets import SyntheticDataset
    from summer_clip_torch.store import FeatureStore
    from summer_clip_torch.models.clip import build_clip

    model, cfg = build_clip("ViT-B/16", torch.Generator().manual_seed(0))
    items = SyntheticDataset().test[:n]
    images = np.stack([SyntheticDataset.render(i.impath, cfg.image_resolution) for i in items])
    with torch.inference_mode():
        ref = model.encode_image(torch.from_numpy(images)).numpy()
    got = FeatureStore(store).load(f"synthetic_test-{tag}", "features")[:n]
    cos = (got * ref).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1))
    return float(cos.min())


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
    for name in ("block_kernels", "cache_kernels"):
        _lib.build(name, verbose=True)
    log(f"phase build: {time.perf_counter() - t0:.2f} s")

    results: dict = {}
    t0 = time.perf_counter()
    check_block_kernels(results)
    check_cache_kernels(results)
    time_towers(results)
    log(f"phase kernels: {time.perf_counter() - t0:.2f} s")

    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        pipe = run_pipeline(Path(tmp))
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
        log(f"phase pipeline: {time.perf_counter() - t0:.2f} s, per app "
            + json.dumps({k: round(v, 3) for k, v in pipe["times_s"].items()}))
        log(f"pipeline launches: {json.dumps(launches)}")
        missing = [k for k, v in launches.items() if v <= 0]
        if missing:
            raise AssertionError(f"main path did not launch {missing}")
        cos = check_features_against_cpu(pipe["store"], pipe["tag"])
        log(f"stored ViT-B/16 features vs f32 CPU model: min cosine {cos:.6f} (tol >= 0.99)")
        if cos < 0.99:
            raise AssertionError("stored features disagree with the f32 model")

    sources = {
        "K5 fused_ln_attn": ("summer_clip_torch/csrc/block_kernels.cu",
                             "summer_clip_tpu/ops/block_kernels.py:255"),
        "K6 fused_ln_mlp": ("summer_clip_torch/csrc/block_kernels.cu",
                            "summer_clip_tpu/ops/block_kernels.py:75"),
        "K3 onehot_grouped": ("summer_clip_torch/csrc/cache_kernels.cu",
                              "summer_clip_tpu/ops/cache_kernels.py:394"),
        "K2 labels_dense": ("summer_clip_torch/csrc/cache_kernels.cu",
                            "summer_clip_tpu/ops/cache_kernels.py:509"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        r = results[name]
        main_shape = r.get("shapes", {}).get("vit_b16_image", r)
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": r["max_abs_err"],
                        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"]})
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
