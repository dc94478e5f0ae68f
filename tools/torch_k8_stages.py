"""Where a launch of K8 (``ops/decode_block``) spends its time, stage by stage.

Runs on a CUDA card: ``python tools/torch_k8_stages.py`` (half a minute on an
H100). It builds a random gpt2-large block stack and rings as ``chip_smoke.py``
does and launches K8 with its ``stamps`` aid: every block's SM cycle count at
the start and the end of its work in each of a block's five stages (qkv,
attention, proj, fc, out). For each stage, averaged over the blocks of the
model: the median and the largest time a block of the grid works, and the span
from the stage's start to the next stage's start (work of the slowest block,
the L2 prefetch of a coming stage, and the grid-wide barrier). Cycles become
microseconds through block 0's wall clock over the whole launch.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

STAGES = ("qkv", "attention", "proj", "fc", "out")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("this tool runs only on a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import k8_fill, random_rings, random_stack
    from summer_clip_torch.ops import decode_block as DB

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    n_layer, d, h, nh = 36, 1280, 5120, 20
    packed = random_stack(n_layer, d, h, "int8", seed=8)
    grid = DB.grid_blocks()
    for batch, t in ((1, 256), (3, 256), (8, 256), (8, 1024)):
        kv = random_rings(n_layer, batch, t, d, torch.int8, seed=batch * t)
        index, pad = k8_fill(batch, t)
        idx = torch.tensor(index, dtype=torch.int32, device="cuda")
        padv = torch.tensor(pad, dtype=torch.int32, device="cuda")
        x = torch.randn((batch, d), device="cuda")
        stamps = torch.zeros(n_layer * 10 * grid + 2, dtype=torch.int64, device="cuda")
        for _ in range(3):
            DB.decode_block(x, packed, kv, idx, nh=nh, pad=padv, stamps=stamps)
        torch.cuda.synchronize()
        wall_ns = int(stamps[-1] - stamps[-2])
        s = stamps[:-2].reshape(n_layer, 5, 2, grid).double()
        cycles = float(s[-1, 4, 1, 0] - s[0, 0, 0, 0])       # block 0, first start to last end
        us = wall_ns / 1e3 / cycles                            # microseconds a cycle
        work = (s[:, :, 1] - s[:, :, 0]) * us                  # (L, 5, grid)
        starts = s[:, :, 0, :].reshape(n_layer * 5, grid)
        span = ((starts[1:] - starts[:-1]) * us).median(dim=1).values   # start to next start
        span = torch.cat([span, span.new_full((1,), float("nan"))]).reshape(n_layer, 5)
        print(f"K8 B={batch} T={t} index {index} pad {pad}: {wall_ns / 1e6:.4f} ms a launch "
              f"({cycles / wall_ns:.3f} GHz), {grid} blocks")
        for i, name in enumerate(STAGES):
            print(f"  {name:9s}: a block works {float(work[:, i].median()):.2f} us (median), "
                  f"{float(work[:, i].max(dim=-1).values.mean()):.2f} us (the slowest, mean over "
                  f"layers); stage start to next start {float(span[:, i].nanmean()):.2f} us")
        print(f"  sum of the spans: {float(span.nanmean(dim=0).sum()) * n_layer / 1e3:.4f} ms")
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
