"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared library
with a plain C interface and loaded through ``ctypes`` (``csrc/*.cuh`` holds
device functions that several sources include). Nothing here runs at
import time: the first CUDA launch of a wrapper calls :func:`load`. The build
goes into ``summer_clip_torch/build/`` (listed in ``.gitignore``), named by a
hash of the source and flags, so an edited source is rebuilt.

A missing ``nvcc`` or a failed build raises: no wrapper falls back to its plain
PyTorch version on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import typing as tp
from pathlib import Path

__all__ = ["build", "load", "check", "torch_stream", "BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS"]

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_LIBS: tp.Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (needed to build summer_clip_torch/csrc kernels); "
                       "set CUDA_HOME or put nvcc on PATH")


def build(name: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` into ``build/lib<name>-<hash>.so`` (cached)."""
    src = CSRC_DIR / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))   # shared device code
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stderr[-4000:]}")
    if verbose and proc.stderr:
        print(proc.stderr)
    os.replace(tmp, out)
    return out


def load(name: str, signatures: tp.Mapping[str, tp.Sequence[tp.Any]]) -> ctypes.CDLL:
    """Build (once) and load ``csrc/<name>.cu``; declare every entry point.

    ``signatures`` maps each C function to its ``argtypes``; every entry
    returns ``cudaError_t`` as an int."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never runs,
    and a later synchronise would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def torch_stream() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream
