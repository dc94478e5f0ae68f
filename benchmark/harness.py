"""The harness: one process runs one cell once.

Set-up (the driver's), the timed window (the driver's, traced with
``--trace 1``), the program's state freed, the correctness comparison against
the plain reference (the driver's), then one JSON line on standard output.
Everything that belongs to one cell, configuration or metric is a file found
by its name:

- ``BENCHMARK.json`` (the repository's root): the cells and the metrics;
- ``benchmark/workloads/<cell>.json``: the cell's driver and traffic;
- ``benchmark/configs/<config>.json``: the published sizes;
- ``benchmark/drivers/<driver>.py``: ``setup``, ``window``, ``release``,
  ``check`` for one kind of traffic;
- ``benchmark/metrics/<metric>.py``: ``read(reading)``, one per-layer
  metric, None where it finds nothing to read.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
import typing as tp
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "summer_clip_tpu")
# the caches a run may build, at fixed paths inside the checkout (git-ignored)
CACHE_DIRS = {"TRITON_CACHE_DIR": ".bench_cache/triton",
              "TORCH_EXTENSIONS_DIR": ".bench_cache/torch_extensions"}


def process_start() -> float:
    """The epoch second this process started (Linux ``/proc``), else now."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start_ticks = int(stat.rsplit(")", 1)[1].split()[19])
        boot = next(int(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines()
                    if line.startswith("btime "))
        return boot + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


class Spans:
    """Spans the harness records around its calls into the program: name,
    start and end on ``perf_counter_ns``; and counters."""

    def __init__(self) -> None:
        self.items: tp.List[tp.Tuple[str, int, int]] = []
        self.counters: tp.Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter_ns()))

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def seconds(self, name: str) -> tp.List[float]:
        return [(t1 - t0) / 1e9 for n, t0, t1 in self.items if n == name]


@dataclasses.dataclass
class Context:
    cell: str
    seed: int
    seconds: float
    trace: bool
    workload: dict
    config: dict
    device: tp.Any
    scratch: Path
    spans: Spans = dataclasses.field(default_factory=Spans)


@dataclasses.dataclass
class Check:
    """One number compared: ``value`` must not pass ``limit``."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Reading:
    """What a per-layer metric reads after a traced window."""
    workload: dict
    config: dict
    window_s: float
    busy_s: float
    kernels: tp.Dict[str, tp.Tuple[int, float]]
    spans: Spans
    end_to_end: tp.Dict[str, float]
    card: tp.Any


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def benchmark_index(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_entry(index: dict, cell: str) -> dict:
    for entry in index["workloads"]:
        if entry["name"] == cell:
            return entry
    raise KeyError(f"no cell {cell!r} in BENCHMARK.json")


def workload_file(cell: str) -> dict:
    return load_json(HERE / "workloads" / f"{cell}.json")


def config_file(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def driver(name: str):
    return load_module(HERE / "drivers" / f"{name}.py", f"benchmark_driver_{name}")


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py", f"benchmark_metric_{name}")


def cell_metrics(index: dict, cell: str, kind: str) -> tp.List[dict]:
    """The cell's ``end_to_end`` or ``per_layer`` entries: those that list
    it, and those without a list whose end-to-end metric the cell reports."""
    e2e = [m for m in index["end_to_end"] if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in index["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


def forbidden_modules() -> tp.List[str]:
    """Modules loaded in this process whose top-level name is JAX's, Flax's
    or the JAX package's (compared whole)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def scratch_dir(cell: str) -> Path:
    """The run's scratch under ``TMPDIR``, emptied first."""
    import shutil

    path = Path(tempfile.gettempdir()) / "summer_clip_bench" / cell
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return path


def parse(argv: tp.Optional[tp.Sequence[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(ctx: Context, drv, state) -> dict:
    """The driver's window, traced or not; the device's peak over it."""
    import torch

    on_card = ctx.device.type == "cuda"
    sync(ctx.device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(ctx.device)
    if ctx.trace:
        from benchmark.devtrace import TraceWindow

        with TraceWindow() as tw:
            out = drv.window(ctx, state)
        out["trace"] = tw
    else:
        out = drv.window(ctx, state)
        sync(ctx.device)
    out["peak_bytes"] = int(torch.cuda.max_memory_allocated(ctx.device)) if on_card else 0
    return out


def per_layer(index: dict, ctx: Context, out: dict) -> tp.Tuple[dict, dict, dict]:
    """(metrics, device additions, breakdown) of a traced window."""
    from benchmark import devtrace, roofline

    tw = out["trace"]
    busy = devtrace.busy_ns(tw.events) / 1e9
    reading = Reading(ctx.workload, ctx.config, out["seconds"], busy,
                      devtrace.by_kernel(tw.events), ctx.spans, out["end_to_end"],
                      roofline.read_card())
    metrics = {}
    for m in cell_metrics(index, ctx.cell, "per_layer"):
        value = metric_reader(m["name"]).read(reading)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    ops = sorted(((name, s) for name, (_, s) in reading.kernels.items()), key=lambda x: -x[1])
    breakdown = {"device_ops": [[n, s] for n, s in ops[:10]],
                 "idle_gaps": devtrace.idle_gaps(tw.events, ctx.spans.items,
                                                 tw.host_offset_ns())}
    return metrics, {"busy_s": busy, "window_s": out["seconds"]}, breakdown


def run_cell(index: dict, ctx: Context, drv, t_start: float, chips: int = 1) -> dict:
    """Set-up, window, release, check; the result line as a dict, its
    ``checks`` last."""
    import torch

    state = drv.setup(ctx)
    sync(ctx.device)
    setup_s = time.time() - t_start
    out = measure(ctx, drv, state)
    payload = drv.release(ctx, state)
    del state
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    checks, failed = drv.check(ctx, payload)
    correct = all(c.ok for c in checks)
    if ctx.trace:
        metrics, extra, breakdown = per_layer(index, ctx, out)
    else:
        values = dict(out["end_to_end"], peak_mem_gib=out["peak_bytes"] / 2 ** 30,
                      setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in cell_metrics(index, ctx.cell, "end_to_end")}
        extra, breakdown = {}, None
    kind = torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu"
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(failed if not correct else 0), "metrics": metrics,
              "device": {"platform": "gpu" if ctx.device.type == "cuda" else "cpu", "kind": kind,
                         "count": chips, "memory_peak_bytes": out["peak_bytes"], **extra}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c.name: {"value": c.value if math.isfinite(c.value) else 1e30,
                                 "limit": c.limit} for c in checks}
    return result


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    import shutil

    t_start = process_start()
    args = parse(argv)
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = str(ROOT / rel)
    index = benchmark_index()
    entry = cell_entry(index, args.workload)
    workload = workload_file(args.workload)
    if workload["config"] != entry["config"]:
        raise ValueError(f"{args.workload}: config {workload['config']} != {entry['config']}")
    config = config_file(entry["config"])
    import torch

    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    ctx = Context(args.workload, args.seed, args.seconds, bool(args.trace), workload, config,
                  torch.device("cuda", 0), scratch_dir(args.workload))
    try:
        result = run_cell(index, ctx, driver(workload["driver"]), t_start, chips)
    finally:
        shutil.rmtree(ctx.scratch, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        print(f"modules that must not load were loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    if ctx.trace:
        from benchmark.roofline import card_line

        print(f"card (the rooflines are shares of its published peaks): {card_line()}",
              file=sys.stderr)
    for name, c in result["checks"].items():
        verdict = "ok" if math.isfinite(c["value"]) and c["value"] <= c["limit"] else "FAILED"
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}) {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
