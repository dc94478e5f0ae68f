"""Cells at a size a CPU test holds: the port's ``test-vit`` widths and a few
rows, the same drivers and files as the benchmark's cells."""

from __future__ import annotations

import copy
import time

import torch

from benchmark import harness

TINY_CONFIG = {"model_name": "test-vit", "embed_dim": 32, "image_resolution": 32,
               "vision_patch_size": 8, "vision_width": 64, "vision_layers": 2, "vision_heads": 1,
               "text_width": 32, "text_heads": 2, "text_layers": 2, "context_length": 77,
               "vocab_size": 49408, "mlp_ratio": 4,
               "dtype": "float32"}
SEED = 2 ** 31 + 12345     # past 32 signed bits, as the benchmark's seeds are


def workload(cell: str) -> dict:
    w = copy.deepcopy(harness.workload_file(cell))
    t = w["traffic"]
    if w["driver"] == "extract":
        t.update(split_images=40, batch=16, pool_images=64, check_rows=8, reference_images=32)
    elif w["driver"] == "tip_search":
        t.update(classes=8, shots=4, test_per_class=5, search_step=[24, 4], feature_noise=0.5,
                 text_noise=20.0)
    else:
        t.update(classnames=t["classnames"][:4], train_per_class=20, test_per_class=10,
                 clip_conf="test_vit")
    return w


def context(cell: str, tmp_path, seed: int = SEED, seconds: float = 0.2) -> harness.Context:
    scratch = tmp_path / "scratch"
    scratch.mkdir(exist_ok=True)
    return harness.Context(cell, seed, seconds, False, workload(cell), dict(TINY_CONFIG),
                           torch.device("cpu"), scratch)


def run(cell: str, tmp_path, seed: int = SEED) -> dict:
    ctx = context(cell, tmp_path, seed)
    return harness.run_cell(harness.benchmark_index(), ctx,
                            harness.driver(ctx.workload["driver"]), time.time())


CELLS = [w["name"] for w in harness.benchmark_index()["workloads"]]
