"""Native host runtime: C++ batched CLIP preprocessing of JPEG files.

Counterpart of ``summer_clip_tpu/native`` with the same arithmetic and the
same Python entry points. Pillow's libjpeg decodes each file at the DCT scale
the C++ rule picks (``Image.draft``), and the C++ (``clip_preprocess.cpp``)
runs the PIL-style antialiased bicubic shorter-side resize, the center crop
and the normalize straight into the caller's float32 row. Pillow's decode and
the ctypes call release the GIL, so a thread pool runs the batch in parallel.
On the same libjpeg this gives the JAX library's pixels bit for bit.

The library builds on first use with g++ (plain C ABI through ctypes, no
libjpeg headers needed) into ``summer_clip_torch/build/`` (git-ignored), named
by a hash of the source and flags, so an edited source is rebuilt. A failed
build keeps the compiler's stderr, and every call after it raises with that
text: nothing here falls back to PIL. The choice between this path and PIL
is the loader's (``data.loader.ImageBatcher``).
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import hashlib
import os
import subprocess
import threading
import typing as tp
from pathlib import Path

import numpy as np

__all__ = ["ensure_built", "is_available", "preprocess_batch", "preprocess_one"]

_SRC = Path(__file__).resolve().parent / "clip_preprocess.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib: tp.Optional[ctypes.CDLL] = None
_build_error: tp.Optional[str] = None
_lock = threading.Lock()
_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def _build() -> ctypes.CDLL:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libclip_preprocess-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_cxx(), *CXX_FLAGS, str(_SRC), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as exc:
            raise RuntimeError(f"{' '.join(cmd)}: {exc}") from None
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in {
            "clip_preprocess_denom": [ctypes.c_int] * 4,
            "clip_preprocess_rgb": [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _F32P]}.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def ensure_built(force: bool = False) -> ctypes.CDLL:
    """Compile (once) and load the library. Raises with the compiler's output
    when the build fails, and with the same output at every call after it
    (``force=True`` tries again)."""
    global _lib, _build_error
    with _lock:
        if force:
            _lib, _build_error = None, None
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise RuntimeError(f"the native preprocess library did not build:\n{_build_error}")
        try:
            _lib = _build()
        except RuntimeError as exc:
            _build_error = str(exc)
            raise RuntimeError(f"the native preprocess library did not build:\n{exc}") from None
        return _lib


def is_available() -> bool:
    """Whether the library builds (and loads) on this host."""
    try:
        ensure_built()
    except RuntimeError:
        return False
    return True


def _pillow_row(lib: ctypes.CDLL, path: str, out_size: int, fast: bool, row: np.ndarray) -> bool:
    """Decode one JPEG with Pillow at the library's DCT scale, then the
    library's resize, crop and normalize into ``row``; False where the file
    is missing or is no JPEG that Pillow decodes."""
    from PIL import Image

    try:
        with Image.open(path) as im:
            if im.format != "JPEG":
                return False
            w, h = im.size
            denom = lib.clip_preprocess_denom(w, h, out_size, int(fast))
            if denom > 1:
                im.draft("RGB", (w // denom, h // denom))
                if im.size != (-(-w // denom), -(-h // denom)):
                    raise RuntimeError(f"{path}: Pillow decodes at {im.size}, not at 1/{denom} "
                                       f"of {(w, h)}")
            rgb = np.ascontiguousarray(np.asarray(im.convert("RGB"), np.uint8))
    except (OSError, SyntaxError, ValueError):
        return False
    lib.clip_preprocess_rgb(rgb.ctypes.data_as(_U8P), rgb.shape[1], rgb.shape[0], out_size,
                            row.ctypes.data_as(_F32P))
    return True


def preprocess_batch(paths: tp.Sequence[str], out_size: int = 224,
                     num_threads: int = 0,
                     out: tp.Optional[np.ndarray] = None,
                     fast: bool = False) -> tp.Tuple[np.ndarray, np.ndarray]:
    """(images (B, S, S, 3) float32, ok (B,) bool). Failed rows are zeros.

    ``fast=True`` relaxes the DCT-scale margin from 2x to 1x the target
    short side: a 480x640 source for a 224 target decodes at half
    resolution (4x fewer IDCT pixels) at a small quality cost. Default off:
    the slow path is the PIL-parity reference. ``num_threads`` <= 0: one a
    core."""
    lib = ensure_built()
    n = len(paths)
    if out is None:
        out = np.zeros((n, out_size, out_size, 3), np.float32)
    if out.shape != (n, out_size, out_size, 3) or out.dtype != np.float32 \
            or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous float32 {(n, out_size, out_size, 3)}, "
                         f"not {out.dtype} {out.shape}")
    threads = num_threads if num_threads > 0 else (os.cpu_count() or 4)
    with cf.ThreadPoolExecutor(max_workers=max(1, min(threads, n))) as pool:
        ok = list(pool.map(lambda i: _pillow_row(lib, str(paths[i]), out_size, fast, out[i]),
                           range(n)))
    return out, np.asarray(ok, bool).reshape(n)


def preprocess_one(path: str, out_size: int = 224) -> tp.Optional[np.ndarray]:
    """(S, S, 3) float32 of one file, or None where it does not decode."""
    images, ok = preprocess_batch([path], out_size, num_threads=1)
    return images[0] if ok[0] else None
