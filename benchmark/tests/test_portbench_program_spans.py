"""The per-layer metrics that read the program's own spans and counters
(``benchmark/program_spans.py``): each tiny cell's window run on the CPU with
the program's recorder on, then read as a traced window is read. The two
block-half rooflines need the card's events and read nothing here."""

import pytest

from benchmark import harness
from benchmark.tests import tiny

PROGRAM_METRICS = ("stage_ms_per_batch", "gather_ms_per_split", "k5_roofline", "k6_roofline",
                   "select_ms_per_pass", "log_ms_per_pass", "points_counted_share")
DEVICE_TIMED = ("k5_roofline", "k6_roofline")


def _read_window(cell, tmp_path):
    from summer_clip_torch.core import profiling

    ctx = tiny.context(cell, tmp_path)
    drv = harness.driver(ctx.workload["driver"])
    st = drv.setup(ctx)
    profiling.reset()
    try:
        with profiling.recording():
            out = drv.window(ctx, st)
        drv.release(ctx, st)
        reading = harness.Reading(ctx.workload, ctx.config, out["seconds"], out["seconds"], {},
                                  ctx.spans, out["end_to_end"], None)
        index = harness.benchmark_index()
        return {m["name"]: harness.metric_reader(m["name"]).read(reading)
                for m in harness.cell_metrics(index, cell, "per_layer")
                if m["name"] in PROGRAM_METRICS}
    finally:
        profiling.reset()


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_program_metrics_read_a_window(cell, tmp_path):
    got = _read_window(cell, tmp_path)
    assert got
    for name, value in got.items():
        if name in DEVICE_TIMED:
            assert value is None, name            # no device events on the CPU
        else:
            assert value is not None and value > 0, name
    if "points_counted_share" in got:
        assert got["points_counted_share"] == 100.0


def test_points_left_out_read_below_100(tmp_path, monkeypatch):
    """Half of the Tip grid's betas left out (the harness still credits the
    whole grid): the program's own count reads 50%."""
    from summer_clip_torch.methods import tip

    grid = tip.beta_alpha_grid

    def half_grid(*args, **kwargs):
        betas, alphas = grid(*args, **kwargs)
        return betas[:len(betas) // 2], alphas

    monkeypatch.setattr(tip, "beta_alpha_grid", half_grid)
    assert _read_window("vitb16.tip_search", tmp_path)["points_counted_share"] == 50.0
