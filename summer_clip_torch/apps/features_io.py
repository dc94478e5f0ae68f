"""Resolving stored features from app configs.

Apps accept either a FeatureStore catalog key (``features_key``) or an
explicit path (``image_features_path`` — ``.npy`` native or a reference-made
``.pt``, auto-transposed from (emb_dim, N)). This replaces the reference's
``saved_paths/clip_paths.yaml`` manual registry.
"""

from __future__ import annotations

import typing as tp
from pathlib import Path

import numpy as np

from summer_clip_torch.store import FeatureStore, import_torch_features, load_array

__all__ = ["resolve_features", "resolve_array"]


def resolve_array(store: tp.Optional[FeatureStore], key: tp.Optional[str],
                  path: tp.Optional[str], name: str = "features") -> np.ndarray:
    if key:
        assert store is not None, "features_key given but no store configured"
        return store.load(key, name)
    assert path, f"need either a store key or a path for {name}"
    p = Path(path)
    if p.suffix == ".pt":
        return import_torch_features(p, transpose=(name == "features"))
    return load_array(p)


def resolve_features(cfg_node, store: tp.Optional[FeatureStore],
                     name: str = "features") -> np.ndarray:
    key = cfg_node.get("features_key") if name == "features" else cfg_node.get(f"{name}_key")
    path = cfg_node.get("image_features_path") if name == "features" else cfg_node.get(f"image_{name}_path")
    return resolve_array(store, key, path, name)
