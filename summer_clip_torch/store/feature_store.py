"""Feature store: the persistence layer between pipeline stages.

The reference's stages communicate through the filesystem: feature
extraction ``torch.save``s an ``(emb_dim, N)`` tensor and a hand-maintained
yaml maps dataset keys to absolute paths (SURVEY.md §1 "storage contract",
reference ``conf/saved_paths/clip_paths.yaml`` + README bookkeeping).

This store keeps the two-phase workflow but removes the manual bookkeeping
and the transpose convention:

- arrays are saved as raw ``.npy`` (one file per array: features / outs /
  labels) in **row-major (N, emb_dim)** orientation — the natural layout for
  XLA matmuls and for memory-mapping row blocks of a huge cache,
- every save auto-registers in a JSON catalog (``catalog.json``) keyed by a
  caller-chosen name, so downstream configs reference keys, not paths,
- loads are ``mmap_mode='r'`` by default: a 1.28M x 1024 ImageNet cache is
  paged in lazily, and sharded consumers can slice rows without reading the
  whole file,
- ``import_torch_features`` ingests reference-produced ``.pt`` tensors
  (transposing their (emb_dim, N) layout) for migration parity.
"""

from __future__ import annotations

import datetime
import json
import typing as tp
from pathlib import Path

import numpy as np

__all__ = ["FeatureStore", "save_array", "load_array", "import_torch_features"]


def save_array(path: tp.Union[str, Path], arr: np.ndarray) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, np.ascontiguousarray(arr))
    return path if path.suffix == ".npy" else path.with_suffix(path.suffix + ".npy")


def load_array(path: tp.Union[str, Path], mmap: bool = True) -> np.ndarray:
    return np.load(path, mmap_mode="r" if mmap else None)


class FeatureStore:
    """Directory-backed array store with a JSON catalog."""

    def __init__(self, root: tp.Union[str, Path]):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.catalog_path = self.root / "catalog.json"

    # -- catalog ---------------------------------------------------------------
    def _read_catalog(self) -> dict:
        if self.catalog_path.exists():
            return json.loads(self.catalog_path.read_text())
        return {}

    def _write_catalog(self, catalog: dict) -> None:
        self.catalog_path.write_text(json.dumps(catalog, indent=2, sort_keys=True))

    def keys(self) -> tp.List[str]:
        return sorted(self._read_catalog())

    def __contains__(self, key: str) -> bool:
        return key in self._read_catalog()

    def meta(self, key: str) -> dict:
        return self._read_catalog()[key]

    # -- save / load -------------------------------------------------------------
    def save(self, key: str, *, features: tp.Optional[np.ndarray] = None,
             outs: tp.Optional[np.ndarray] = None,
             labels: tp.Optional[np.ndarray] = None,
             extra: tp.Optional[tp.Dict[str, np.ndarray]] = None,
             meta: tp.Optional[dict] = None) -> dict:
        """Save named arrays under ``<root>/<key>/`` and register them.

        ``features`` must be (N, emb_dim); ``outs`` (N, C); ``labels`` (N,).
        """
        arrays: tp.Dict[str, np.ndarray] = {}
        if features is not None:
            arrays["features"] = np.asarray(features)
        if outs is not None:
            arrays["outs"] = np.asarray(outs)
        if labels is not None:
            arrays["labels"] = np.asarray(labels)
        for name, arr in (extra or {}).items():
            arrays[name] = np.asarray(arr)
        assert arrays, "nothing to save"

        key_dir = self.root / key
        entry: dict = {
            "arrays": {}, "meta": meta or {},
            "created": datetime.datetime.now().isoformat(timespec="seconds"),
        }
        for name, arr in arrays.items():
            p = key_dir / f"{name}.npy"
            save_array(p, arr)
            entry["arrays"][name] = {
                "path": str(p.relative_to(self.root)),
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
            }
        catalog = self._read_catalog()
        catalog[key] = entry
        self._write_catalog(catalog)
        return entry

    def load(self, key: str, name: str = "features", mmap: bool = True) -> np.ndarray:
        entry = self._read_catalog()[key]
        rel = entry["arrays"][name]["path"]
        return load_array(self.root / rel, mmap=mmap)

    def load_all(self, key: str, mmap: bool = True) -> tp.Dict[str, np.ndarray]:
        entry = self._read_catalog()[key]
        return {name: load_array(self.root / info["path"], mmap=mmap)
                for name, info in entry["arrays"].items()}

    def path_of(self, key: str, name: str = "features") -> Path:
        return self.root / self._read_catalog()[key]["arrays"][name]["path"]


def import_torch_features(pt_path: tp.Union[str, Path],
                          transpose: bool = True) -> np.ndarray:
    """Ingest a reference-produced ``.pt`` feature tensor.

    The reference persists image features as (emb_dim, N)
    (``clip_adapter/save_features.py:36``); ``transpose=True`` converts to
    this framework's (N, emb_dim).
    """
    import torch

    t = torch.load(str(pt_path), map_location="cpu", weights_only=False)
    arr = t.float().numpy() if hasattr(t, "float") else np.asarray(t, np.float32)
    return np.ascontiguousarray(arr.T) if transpose else np.ascontiguousarray(arr)
