"""Auto-numbered tensor dumps (reference ``clip_searcher/utils.py:24-52``)."""

from __future__ import annotations

import typing as tp
from pathlib import Path

import numpy as np

__all__ = ["TensorsNumpySaver"]


class TensorsNumpySaver:
    def __init__(self, out_dir: tp.Union[str, Path]):
        self.out_dir = Path(out_dir)
        self._counter = 0

    def _ensure(self) -> None:
        self.out_dir.mkdir(parents=True, exist_ok=True)

    def save_tensor(self, arr) -> Path:
        self._ensure()
        path = self.out_dir / f"tensor_{self._counter:05d}.npy"
        self._counter += 1
        np.save(path, np.asarray(arr))
        return path

    def save_named_tensor(self, arr, name: str) -> Path:
        self._ensure()
        path = self.out_dir / f"{name}.npy"
        np.save(path, np.asarray(arr))
        return path
