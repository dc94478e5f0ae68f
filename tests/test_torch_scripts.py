"""The port's launch scripts (``scripts/torch/*.sh``): one for each of the JAX
package's ``scripts/*.sh``, of the same name, each naming an entry point of
the port that exists and none of the JAX package, each passing its arguments
through (run here with a stand-in ``python`` on ``PATH`` that prints what it
was given)."""

import importlib
import importlib.util
import os
import re
import subprocess
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
OLD = sorted(p.name for p in (REPO / "scripts").glob("*.sh"))
NEW = REPO / "scripts" / "torch"
# the two scripts that call a function instead of running an app module
FUNCTIONS = {"tip_adapter_imagenet.sh": ("summer_clip_torch.apps.tip_adapter", "run_imagenet"),
             "run_anomalous_tokens.sh": ("summer_clip_torch.sandbox.anomalous_tokens",
                                         "backwards_main")}


def test_one_port_script_for_every_script():
    assert len(OLD) == 22
    assert sorted(p.name for p in NEW.glob("*.sh")) == OLD


@pytest.mark.parametrize("name", OLD)
def test_port_script_names_a_port_entry_point_and_nothing_of_the_jax_package(name):
    text = (NEW / name).read_text()
    assert os.access(NEW / name, os.X_OK)
    assert "summer_clip_tpu" not in text and not re.search(r"\btpu\b", text, re.I)
    assert subprocess.run(["bash", "-n", str(NEW / name)]).returncode == 0
    modules = re.findall(r"-m (summer_clip_torch\.apps\.\w+)", text)
    if name in FUNCTIONS:
        module, fn = FUNCTIONS[name]
        assert f"from {module} import {fn}" in text and not modules
        assert callable(getattr(importlib.import_module(module), fn))
    elif name == "upl.sh":   # forwards to an external checkout, as scripts/upl.sh does
        assert not modules and "UPL_ROOT" in text and "summer_clip" not in text.replace(
            "scripts/torch/save_features.sh", "")
    else:
        assert modules == [f"summer_clip_torch.apps.{name[:-3]}"]
        assert importlib.util.find_spec(modules[0]) is not None


@pytest.fixture
def stand_in_python(tmp_path):
    """A ``python`` that prints its arguments and its standard input."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    exe = bin_dir / "python"
    exe.write_text('#!/bin/sh\necho "ARGS $*"\nif [ "$2" = "-" ]; then cat; fi\n')
    exe.chmod(0o755)
    return {**os.environ, "PATH": f"{bin_dir}:{os.environ['PATH']}"}


@pytest.mark.parametrize("name", [n for n in OLD if n != "upl.sh"])
def test_port_script_passes_its_arguments_through(name, stand_in_python):
    out = subprocess.run(["bash", str(NEW / name), "a.b=1", "c=two words"], env=stand_in_python,
                         capture_output=True, text=True, stdin=subprocess.DEVNULL, timeout=60)
    assert out.returncode == 0, out.stderr
    first = out.stdout.splitlines()[0]
    if name == "tip_adapter_imagenet.sh":
        assert first == "ARGS -u - a.b=1 c=two words"
        assert "run_imagenet(argv=sys.argv[1:])" in out.stdout
    elif name == "run_anomalous_tokens.sh":
        assert first == "ARGS -u -c " and "backwards_main(sys.argv[1:])" in out.stdout
        assert out.stdout.rstrip().endswith("a.b=1 c=two words")
    else:
        assert first == f"ARGS -u -m summer_clip_torch.apps.{name[:-3]} a.b=1 c=two words"


def test_upl_script_needs_its_checkout():
    out = subprocess.run(["bash", str(NEW / "upl.sh")], capture_output=True, text=True,
                         env={k: v for k, v in os.environ.items() if k != "UPL_ROOT"}, timeout=60)
    assert out.returncode == 2 and "UPL_ROOT" in out.stderr
