"""The benchmark finds every cell, configuration, driver and metric by name,
and ``BENCHMARK.json`` keeps to its contract's shape."""

import json
import re

import pytest

from benchmark import harness
from benchmark.tests.tiny import CELLS

INDEX = harness.benchmark_index()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry = harness.cell_entry(INDEX, cell)
    w = harness.workload_file(cell)
    assert w["config"] == entry["config"] and w["chips"] == entry["chips"] == 1
    drv = harness.driver(w["driver"])
    for fn in ("setup", "window", "release", "check", "control"):
        assert callable(getattr(drv, fn)), (w["driver"], fn)
    e2e = {m["name"] for m in harness.cell_metrics(INDEX, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(INDEX, cell, "per_layer")
    assert all(v > 0 for v in w["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in INDEX["per_layer"]])
def test_metric_reader_found_by_name(metric):
    m = next(x for x in INDEX["per_layer"] if x["name"] == metric)
    reader = harness.metric_reader(metric)
    for cell in m["workloads"]:
        w = harness.workload_file(cell)
        empty = harness.Reading(w, harness.config_file(w["config"]), 10.0, 0.0, {},
                                harness.Spans(), {}, None)
        assert reader.read(empty) is None      # nothing to read: no number, never 0
        # every cell that reports it reports the end-to-end metric it moves
        assert m["moves"] in {e["name"] for e in harness.cell_metrics(INDEX, cell, "end_to_end")}


@pytest.mark.parametrize("config", [c["name"] for c in INDEX["configs"]])
def test_config_matches_the_port(config):
    from summer_clip_torch.models.clip.configs import CLIP_CONFIGS

    entry = next(c for c in INDEX["configs"] if c["name"] == config)
    c = harness.config_file(config)
    assert entry["file"] == f"benchmark/configs/{config}.json" and c["name"] == config
    assert entry["reduced"] == c["reduced"] == []
    p = CLIP_CONFIGS[c["model_name"]]
    assert (p.embed_dim, p.image_resolution, p.vision_width, p.vision_layers,
            p.vision_patch_size, p.vision_heads, p.text_width, p.text_heads, p.text_layers,
            p.context_length, p.vocab_size) == (
        c["embed_dim"], c["image_resolution"], c["vision_width"], c["vision_layers"],
        c["vision_patch_size"], c["vision_heads"], c["text_width"], c["text_heads"],
        c["text_layers"], c["context_length"], c["vocab_size"])


def test_index_shape():
    assert set(INDEX) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert INDEX["paths"] == ["benchmark"] and INDEX["command"] == ["python3", "benchmark/run.py"]
    rs = INDEX["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in INDEX[k]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for m in INDEX["end_to_end"] + INDEX["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in INDEX["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in INDEX["end_to_end"]} == {"images_per_s", "sweep_points_per_s",
                                                       "peak_mem_gib", "setup_s"}
    for w in INDEX["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert len(json.dumps(INDEX)) <= 64 * 1024


def test_layers_named_in_perf_md():
    text = (harness.ROOT / "PERF.md").read_text()
    for m in INDEX["per_layer"]:
        assert f"| {m['layer']} |" in text, m["layer"]
