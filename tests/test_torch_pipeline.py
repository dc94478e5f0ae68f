"""The port's save_features -> eval_clip -> tip_adapter against the JAX apps.

Both packages run in this one process (``SyntheticDataset.render`` seeds from
the salted ``hash(impath)``, so images agree only within a process), load the
same ``test-vit`` weights from one OpenAI-layout ``.pt``, and run each app in
its own working directory. Stored features must agree to 1e-4 (f32 towers,
summation order only) and the accuracy records must be equal.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def _records(run_root: Path, kind: str):
    recs = []
    for p in run_root.rglob("records.jsonl"):
        recs.extend(json.loads(line) for line in p.read_text().splitlines())
    return [r for r in recs if r.get("type") == kind]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from summer_clip_torch.models.clip import build_clip, to_openai_state_dict

    model, _ = build_clip("test-vit", torch.Generator().manual_seed(3), device="cpu")
    path = tmp_path_factory.mktemp("ckpt") / "test_vit.pt"
    torch.save(to_openai_state_dict(model), path)
    return str(path)


def _run_apps(pkg: str, root: Path, ckpt: str, monkeypatch) -> Path:
    import importlib

    save_features = importlib.import_module(f"{pkg}.apps.save_features")
    eval_clip = importlib.import_module(f"{pkg}.apps.eval_clip")
    tip_adapter = importlib.import_module(f"{pkg}.apps.tip_adapter")
    store = root / "features"
    common = ["clip=test_vit", f"clip.checkpoint_path={ckpt}",
              *(["meta.device=cpu"] if pkg == "summer_clip_torch" else [])]
    for app, argv in (
        (save_features, ["dataset_name=synthetic", "dataset@train_dataset=synthetic_train",
                         "dataset@test_dataset=synthetic_test", "data.batch_size=8",
                         f"store.root={store}"]),
        (eval_clip, ["dataset_name=synthetic", "dataset=synthetic_test", f"store.root={store}",
                     "eval.features_key=synthetic_test-test-vit"]),
        (tip_adapter, ["dataset=synthetic", "root_path=''", "shots=2", "augment_epoch=2",
                       "data.batch_size=8", "search_step=[4,3]", "search_scale=[7,3]"]),
    ):
        sub = root / app.__name__.rsplit(".", 1)[1]
        sub.mkdir(parents=True)
        monkeypatch.chdir(sub)
        app.run(argv=common + argv)
    return root


def test_apps_match_jax(tmp_path, monkeypatch, ckpt):
    from summer_clip_tpu.store import FeatureStore

    jax_root = _run_apps("summer_clip_tpu", tmp_path / "jax", ckpt, monkeypatch)
    port_root = _run_apps("summer_clip_torch", tmp_path / "torch", ckpt, monkeypatch)

    js, ts = FeatureStore(jax_root / "features"), FeatureStore(port_root / "features")
    for key in ("synthetic_train-test-vit", "synthetic_test-test-vit"):
        assert key in ts
        np.testing.assert_allclose(ts.load(key, "features"), js.load(key, "features"),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(ts.load(key, "labels"), js.load(key, "labels"))
    np.testing.assert_allclose(ts.load("synthetic_train-test-vit", "outs"),
                               js.load("synthetic_train-test-vit", "outs"), rtol=1e-4, atol=1e-4)
    for kind in ("zero_shot", "tip_result", "tip_searched"):
        got = _records(port_root, kind)
        want = _records(jax_root, kind)
        assert got and len(got) == len(want), kind
        for g, w in zip(got, want):
            for k in ("acc1", "acc5", "beta", "alpha"):
                if k in w:
                    assert g[k] == pytest.approx(w[k], abs=1e-6), (kind, k, g, w)


_IMPORT_ALL = """
import importlib, pkgutil, sys
import summer_clip_torch
names = [m.name for m in pkgutil.walk_packages(summer_clip_torch.__path__, 'summer_clip_torch.')]
for n in names:
    importlib.import_module(n)
import chip_smoke
assert 'jax' not in sys.modules, sorted(m for m in sys.modules if m.startswith('jax'))
print(len(names))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_port_sources_never_import_jax():
    for path in (REPO / "summer_clip_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import jax", "from jax")), (path, line)
