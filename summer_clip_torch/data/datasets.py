"""Datasets the port adds to the shared registry.

``synthetic_1k``: the procedural ``synthetic`` dataset at ImageNet's class
count (1000 classes; 2 train, 1 val and 1 test image per class). A 1-shot Tip
cache over it spans 1000 classes in one cache block, which routes the sweep
to the label-built dense kernel (K2) exactly as a 1-shot ImageNet cache does;
the 4-class ``synthetic`` cache takes the class-grouped kernel (K3).
"""

from __future__ import annotations

import typing as tp

import numpy as np

from summer_clip_tpu.data.datasets import SyntheticDataset, register_dataset

__all__ = ["SyntheticDataset", "SyntheticImageNetScale"]


@register_dataset("synthetic_1k")
class SyntheticImageNetScale(SyntheticDataset):
    def __init__(self, root: str = "", num_shots: int = -1, *,
                 rng: tp.Optional[np.random.Generator] = None):
        super().__init__(root, num_shots, num_classes=1000, per_class=2, rng=rng)
