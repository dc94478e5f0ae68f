"""The port stands alone: it imports ``torch``, never ``jax``, and nothing of
the JAX package; its apps compose the port's own ``conf/``; and the feature
store's on-disk format is shared, so either package reads what the other wrote.

The import checks run in a subprocess, because this test process has both
packages loaded.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "summer_clip_torch"
APPS = ["save_features", "eval_clip", "tip_adapter", "tip_adapter_imagenet", "image_attention",
        "save_image_outs", "save_image_labels", "gen_gpt", "train_coop", "eval_prompt",
        "train_adapter", "eval_adapter", "class_projector", "maha_distance", "train_em",
        "train_autoprompt", "train_prolip"]
# the port's tools (those that import it) never import the JAX package
TOOLS = sorted(p for p in (REPO / "tools").glob("torch_*.py")
               if "summer_clip_torch" in p.read_text())

_WALK = """
import importlib, pkgutil, sys
import summer_clip_torch
from summer_clip_torch.core import config as C
names = [m.name for m in pkgutil.walk_packages(summer_clip_torch.__path__, 'summer_clip_torch.')]
for n in names:
    importlib.import_module(n)
conf = C.Path(summer_clip_torch.__file__).parent / 'conf'
for app in %r:
    cfg = C.compose(conf, app, [])
    text = C.to_yaml(cfg)
    assert 'summer_clip_tpu' not in text, (app, text)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax') or m.startswith('summer_clip_tpu'))
assert not bad, bad
print(len(names))
"""


def test_walk_imports_and_compose_configs_without_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    out = subprocess.run([sys.executable, "-c", _WALK % (APPS,)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) >= 40


_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|summer_clip_tpu)\b")


@pytest.mark.parametrize("path", sorted([*PORT.rglob("*.py"), REPO / "chip_smoke.py", *TOOLS]),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_of_jax_or_the_jax_package(path):
    for no, line in enumerate(path.read_text().splitlines(), 1):
        assert not _IMPORT.match(line), f"{path}:{no}: {line}"
        assert "summer_clip_tpu/conf" not in line or "config_path" not in line, f"{path}:{no}"


def test_every_config_path_and_target_points_into_the_port():
    for path in PORT.rglob("*.py"):
        for m in re.finditer(r"config_path\s*=\s*[\"']([^\"']+)[\"']", path.read_text()):
            target = (path.parent / m.group(1)).resolve()
            assert target == PORT / "conf", (path, m.group(1))
    yamls = sorted((PORT / "conf").rglob("*.yaml"))
    assert len(yamls) >= 50
    for y in yamls:
        for line in y.read_text().splitlines():
            if "_target_" in line:
                assert "summer_clip_torch." in line, (y, line)
            assert "summer_clip_tpu." not in line, (y, line)


@pytest.mark.parametrize("app", APPS)
def test_port_conf_equals_the_jax_packages_up_to_the_package_name(app):
    """The copies are copies: composed with no overrides, each app's config
    equals the JAX package's once the package name is mapped."""
    from summer_clip_torch.core import config as TC
    from summer_clip_tpu.core import config as JC

    got = TC.to_container(TC.compose(PORT / "conf", app, []), resolve=False)
    want = JC.to_container(JC.compose(REPO / "summer_clip_tpu" / "conf", app, []), resolve=False)

    def rename(node):
        if isinstance(node, dict):
            return {k: rename(v) for k, v in node.items()}
        if isinstance(node, list):
            return [rename(v) for v in node]
        return node.replace("summer_clip_tpu", "summer_clip_torch") if isinstance(node, str) else node

    assert got == rename(want)


@pytest.mark.parametrize("writer,reader", [("summer_clip_tpu", "summer_clip_torch"),
                                           ("summer_clip_torch", "summer_clip_tpu")])
def test_feature_store_round_trip_between_packages(tmp_path, writer, reader):
    import importlib

    w = importlib.import_module(f"{writer}.store")
    r = importlib.import_module(f"{reader}.store")
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((9, 16)).astype(np.float32)
    outs = rng.standard_normal((9, 4)).astype(np.float32)
    labels = np.arange(9, dtype=np.int32)
    w.FeatureStore(tmp_path / "fs").save("toy_train-test-vit", features=feats, outs=outs,
                                         labels=labels, extra={"values": outs * 2},
                                         meta={"model": "test-vit"})
    store = r.FeatureStore(tmp_path / "fs")
    assert "toy_train-test-vit" in store
    np.testing.assert_array_equal(store.load("toy_train-test-vit", "features"), feats)
    np.testing.assert_array_equal(store.load("toy_train-test-vit", "outs"), outs)
    np.testing.assert_array_equal(store.load("toy_train-test-vit", "labels"), labels)
    np.testing.assert_array_equal(store.load_all("toy_train-test-vit", mmap=False)["values"],
                                  outs * 2)
    path = w.save_array(tmp_path / "plain.npy", feats)
    np.testing.assert_array_equal(r.load_array(path), feats)
