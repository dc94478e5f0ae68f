"""What a run loads: nothing of JAX, Flax or the JAX package in the process
that runs a cell (top-level names compared whole: ``summer_clip_torch``
begins with ``summer_clip_t``), nothing of the program in the reference; and
no result without a card, or in a directory holding only the benchmark."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

ROOT = harness.ROOT


def _python(code: str, cwd=ROOT, env_extra=None) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "summer_clip_tpu_lookalike", sys)
    assert "summer_clip_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "summer_clip_tpu.apps", sys)
    assert "summer_clip_tpu" in harness.forbidden_modules()


def test_a_run_loads_no_jax(tmp_path):
    code = f"""
import sys, json, pathlib
sys.path.insert(0, {str(ROOT)!r})
from benchmark.tests import tiny
for cell in tiny.CELLS:
    r = tiny.run(cell, pathlib.Path({str(tmp_path)!r}) / cell.replace('.', '_'))
    assert r["correct"], cell
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    for cell_dir in ("vitl14_extract", "vitb16_tip_search", "vitl14_clip_search",
                     "vitb16_extract"):
        (tmp_path / cell_dir).mkdir()
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "summer_clip_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN), loaded & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    code = f"""
import sys, json
sys.path.insert(0, {str(ROOT)!r})
import benchmark.reference.clip, benchmark.reference.cache, benchmark.reference.tokenizer
import benchmark.roofline, benchmark.traffic, benchmark.weights
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"summer_clip_torch", *harness.FORBIDDEN}


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "vitl14.extract",
                          "--seed", str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "vitb16.extract",
                          "--seed", "7", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
