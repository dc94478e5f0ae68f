"""Readings that set a cell's limits: the program's numbers over many seeds
(sound runs, a short window each) and its control's (the program's own lower
precision where it has one, else the plain reference one precision step
down, in the program's place) over a few, at the cell's own size, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --control-seeds 1,2,3 \
        [--seconds 0] [--out <file.jsonl>]

Each reading is a JSON line: ``{"cell", "seed", "side", "checks": {name: value}}``.
"""

from __future__ import annotations

import argparse
import gc
import json
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402


def readings(cell: str, seeds, control_seeds, seconds: float, out) -> None:
    import torch

    index = harness.benchmark_index()
    entry = harness.cell_entry(index, cell)
    workload, config = harness.workload_file(cell), harness.config_file(entry["config"])
    drv = harness.driver(workload["driver"])
    dev = torch.device("cuda", 0)
    jobs = [("program", s) for s in seeds] + [("control", s) for s in control_seeds]
    for side, seed in jobs:
        ctx = harness.Context(cell, seed, seconds, False, workload, config, dev,
                              harness.scratch_dir(cell))
        t0 = time.time()
        if side == "program":
            state = drv.setup(ctx)
            out_w = drv.window(ctx, state)
            payload = drv.release(ctx, state)
            del state
            gc.collect()
            torch.cuda.empty_cache()
            checks, _ = drv.check(ctx, payload)
            extra = {"attempted": out_w["attempted"]}
        else:
            checks, extra = drv.control(ctx), {}
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(ctx.scratch, ignore_errors=True)
        line = {"cell": cell, "seed": seed, "side": side, "seconds": time.time() - t0,
                "checks": {c.name: c.value for c in checks}, **extra}
        print(json.dumps(line), flush=True)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(line) + "\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    readings(a.workload, ints(a.seeds), ints(a.control_seeds), a.seconds, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
