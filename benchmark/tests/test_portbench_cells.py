"""Each cell run through the harness at a tiny size on the CPU: the result
line's keys, ``correct`` on a sound run, ``correct`` false with the timed path
broken underneath (an answer altered where it is produced; two rows of a
batch swapped; half of the rows left out; half of the Tip grid left out), and
the control's path. The control at the cell's own size runs on
the card (``cuda`` marker)."""

import json

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_sound_run_is_correct(cell, tmp_path):
    r = tiny.run(cell, tmp_path)
    assert list(r) == KEYS                     # ``checks`` comes last
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    want = {m["name"] for m in harness.cell_metrics(harness.benchmark_index(), cell, "end_to_end")}
    assert set(r["metrics"]) == want
    assert all(m["value"] > 0 for k, m in r["metrics"].items() if k != "peak_mem_gib")
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    json.loads(json.dumps(r))


def _alter_rows(fn, share):
    """``fn`` with the first ``share`` of each output's rows scaled (an answer
    altered where it is produced)."""
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        n = max(1, int(out.shape[-2] * share))
        out[..., :n, :] *= 1.5
        return out
    return wrapped


def _drop_half(fn):
    """``fn`` with half of the test rows left out of the cache logits."""
    def wrapped(test, *args, **kwargs):
        out = fn(test, *args, **kwargs).clone()
        out[..., out.shape[-2] // 2:, :] = 0
        return out
    return wrapped


def _swap_rows(fn):
    """``fn`` with the first two rows of each batch's features swapped."""
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        out[[0, 1]] = out[[1, 0]]
        return out
    return wrapped


def _half_grid(fn):
    """The search's grid with its second half of betas left out: a search
    that stops after half of its chunks."""
    def wrapped(*args, **kwargs):
        betas, alphas = fn(*args, **kwargs)
        return betas[:len(betas) // 2], alphas
    return wrapped


FAULTS = {
    "extract_row": ("extract", "summer_clip_torch.apps.common.ClipSession.encode_image",
                    lambda f: _alter_rows(f, 0.1)),
    "extract_swap_rows": ("extract", "summer_clip_torch.apps.common.ClipSession.encode_image",
                          _swap_rows),
    "tip_half_grid": ("tip_search", "summer_clip_torch.methods.tip.beta_alpha_grid",
                      _half_grid),
    "tip_half_rows": ("tip_search", "summer_clip_torch.methods.tip.cache_attention_auto",
                      _drop_half),
    "clip_search_half_rows": ("clip_search",
                              "summer_clip_torch.apps.image_attention.cache_attention_auto",
                              _drop_half),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, tmp_path, monkeypatch):
    import importlib

    kind, target, make = FAULTS[fault]
    module_name, attr = target.rsplit(".", 1)
    if module_name.endswith("ClipSession"):
        owner = importlib.import_module(module_name.rsplit(".", 1)[0]).ClipSession
    else:
        owner = importlib.import_module(module_name)
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    for cell in tiny.CELLS:
        if harness.workload_file(cell)["driver"] == kind:
            r = tiny.run(cell, tmp_path)
            assert r["correct"] is False, (cell, r["checks"])
            assert r["failed"] >= 1


@pytest.mark.parametrize("cell", [c for c in tiny.CELLS
                                  if harness.workload_file(c)["driver"] != "extract"])
def test_control_path_runs(cell, tmp_path):
    ctx = tiny.context(cell, tmp_path)
    checks = harness.driver(ctx.workload["driver"]).control(ctx)
    assert checks and all(np.isfinite(c.value) for c in checks)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's own size")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_fails_at_cell_size(cell, card, tmp_path):
    index = harness.benchmark_index()
    w = harness.workload_file(cell)
    ctx = harness.Context(cell, tiny.SEED, 0.0, False, w,
                          harness.config_file(harness.cell_entry(index, cell)["config"]), card,
                          tmp_path)
    checks = harness.driver(w["driver"]).control(ctx)
    assert not all(c.ok for c in checks), [(c.name, c.value, c.limit) for c in checks]
