"""Where a launch of K8 (``ops/decode_block``) spends its time, stage by stage.

Runs on a CUDA card: ``python tools/torch_k8_stages.py [--phases]`` (half a
minute on an H100). It builds a random gpt2-large block stack and rings as
``chip_smoke.py`` does and launches K8 with its ``stamps`` aid: every CTA's SM
cycle count at the start and the end of its work in each of a block's five
stages (qkv, attention, proj, fc, out). For each stage, averaged over the
blocks of the model: the median and the largest time a CTA of the grid works
(its cluster barriers included), and the span from the stage's start to the
next stage's start (work of the slowest CTA and the grid-wide barrier). Cycles
become microseconds through CTA 0's wall clock over the whole launch.

``--phases`` builds another copy of ``csrc/decode_kernels.cu`` with
``-DK8_PROBE`` and prints, for each stage, the median time of each phase of a
CTA's first tile (or attention unit): a product stage's entry, its rows
staged, its weight boxes resident, the products, the tile's sums, the cluster
barrier, the epilogue; the attention's entry, its first memory trip, the fresh
row, the scores and their max, p and its sum, the weighted sum of V, the store.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

STAGES = ("qkv", "attention", "proj", "fc", "out")
PHASES = {"product": ("entry", "rows staged", "boxes resident", "products", "tile sums",
                      "cluster barrier", "epilogue"),
          "attention": ("entry", "first trip", "fresh row", "scores + max", "p + sum",
                        "weighted V", "store")}


def probe_build():
    """decode_kernels.cu built with -DK8_PROBE, in place of the tree's build."""
    from summer_clip_torch.ops import _lib
    from summer_clip_torch.ops import decode_block as DB

    out = Path(tempfile.mkdtemp(prefix="k8_probe_")) / "libdecode_probe.so"
    proc = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-DK8_PROBE", "-o", str(out),
                           str(_lib.CSRC_DIR / "decode_kernels.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in DB._SIGNATURES.items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = list(argtypes), ctypes.c_int
    _lib._LIBS["decode_kernels"] = lib


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", action="store_true", help="also time the phases inside a stage")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("this tool runs only on a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import k8_fill, random_rings, random_stack
    from summer_clip_torch.ops import decode_block as DB

    if args.phases:
        probe_build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    n_layer, d, h, nh = 36, 1280, 5120, 20
    packed = random_stack(n_layer, d, h, "int8", seed=8)
    grid = DB.grid_blocks()
    base = n_layer * 10 * grid + 2
    for batch, t in ((1, 256), (3, 256), (8, 256), (8, 1024)):
        kv = random_rings(n_layer, batch, t, d, torch.int8, seed=batch * t)
        index, pad = k8_fill(batch, t)
        idx = torch.tensor(index, dtype=torch.int32, device="cuda")
        padv = torch.tensor(pad, dtype=torch.int32, device="cuda")
        x = torch.randn((batch, d), device="cuda")
        stamps = torch.zeros(base + (n_layer * 5 * 8 * grid if args.phases else 0),
                             dtype=torch.int64, device="cuda")
        for _ in range(3):
            stamps.zero_()
            DB.decode_block(x, packed, kv, idx, nh=nh, pad=padv, stamps=stamps)
        torch.cuda.synchronize()
        wall_ns = int(stamps[base - 1] - stamps[base - 2])
        s = stamps[:base - 2].reshape(n_layer, 5, 2, grid).double()
        cycles = float(s[-1, 4, 1, 0] - s[0, 0, 0, 0])       # CTA 0, first start to last end
        us = wall_ns / 1e3 / cycles                            # microseconds a cycle
        work = (s[:, :, 1] - s[:, :, 0]) * us                  # (L, 5, grid)
        starts = s[:, :, 0, :].reshape(n_layer * 5, grid)
        span = ((starts[1:] - starts[:-1]) * us).median(dim=1).values   # start to next start
        span = torch.cat([span, span.new_full((1,), float("nan"))]).reshape(n_layer, 5)
        print(f"K8 B={batch} T={t} index {index} pad {pad}: {wall_ns / 1e6:.4f} ms a launch "
              f"({cycles / wall_ns:.3f} GHz), {grid} CTAs")
        for i, name in enumerate(STAGES):
            print(f"  {name:9s}: a CTA works {float(work[:, i].median()):.2f} us (median), "
                  f"{float(work[:, i].max(dim=-1).values.mean()):.2f} us (the slowest, mean over "
                  f"layers); stage start to next start {float(span[:, i].nanmean()):.2f} us")
        print(f"  sum of the spans: {float(span.nanmean(dim=0).sum()) * n_layer / 1e3:.4f} ms")
        if args.phases:
            ph = stamps[base:].reshape(n_layer, 5, 8, grid).double()
            for i, name in enumerate(STAGES):
                prev, cols = s[:, i, 0, :], []
                for slot, label in enumerate(PHASES["attention" if i == 1 else "product"]):
                    v = ph[:, i, slot, :]
                    ok = (v > 0) & (prev > 0)
                    dt = ((v - prev) * us)[ok]
                    cols.append(f"{label} {float(dt.median()) if dt.numel() else float('nan'):.2f}")
                    prev = torch.where(v > 0, v, prev)
                print(f"    {name:9s} phases (us, median): " + ", ".join(cols))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
