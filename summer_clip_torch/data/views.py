"""Dataset views: split selection + transform policy, consumed by batchers.

Functional replacement for the reference's ``TipAdapterDataset`` /
``NoImageImageNetDataset`` wrappers (``summer_clip/utils/datasets.py``):
a view binds (dataset name, split, root, shots) and exposes the Datum list,
class names and prompt template; batching happens in
:mod:`summer_clip_torch.data.loader`.
"""

from __future__ import annotations

import typing as tp

import numpy as np

from summer_clip_torch.data.core import Datum, DatasetBase
from summer_clip_torch.data.datasets import build_dataset
from summer_clip_torch.data.loader import ImageBatcher, labels_of
from summer_clip_torch.data.transforms import EvalTransform, TrainTransform

__all__ = ["DatasetView", "TipAdapterDataset", "NoImageDataset"]


class DatasetView:
    """One split of a registered dataset with its preprocessing policy."""

    def __init__(self, dataset: str, split: str, root_path: str, shots: int = -1,
                 input_size: int = 224, is_train: bool = False,
                 use_custom_preprocess: bool = False, load_images: bool = True,
                 seed: int = 0, device_normalize: bool = False, k_tfm: int = 1,
                 **dataset_kwargs):
        rng = np.random.default_rng(seed)
        self.base: DatasetBase = build_dataset(dataset, root_path, shots, rng=rng, **dataset_kwargs)
        self.split = split
        self.data: tp.List[Datum] = self._select_split(self.base, split)
        self.load_images = load_images
        self.is_train = is_train
        self.input_size = input_size
        # multi-view augmentation only applies under a train transform
        # (reference DatasetWrapper: k_tfm if is_train else 1, utils.py:322)
        self.k_tfm = k_tfm if is_train else 1
        if is_train or use_custom_preprocess:
            self.transform: tp.Any = TrainTransform(input_size, device_normalize=device_normalize)
        else:
            self.transform = EvalTransform(input_size, device_normalize=device_normalize)

    @staticmethod
    def _select_split(dataset: DatasetBase, split: str) -> tp.List[Datum]:
        try:
            return {"train": dataset.train_x, "val": dataset.val, "test": dataset.test}[split]
        except KeyError:
            raise ValueError(f"Unsupported split name: {split!r}") from None

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, i: int) -> Datum:
        return self.data[i]

    def __iter__(self):
        return iter(self.data)

    @property
    def classes(self) -> tp.List[str]:
        return self.base.classnames

    @property
    def template(self) -> tp.List[str]:
        return self.base.template

    def labels(self) -> np.ndarray:
        return labels_of(self.data)

    def batcher(self, batch_size: int = 256, shuffle: bool = False,
                seed: int = 0, **kwargs) -> ImageBatcher:
        kwargs.setdefault("k_tfm", self.k_tfm)
        return ImageBatcher(self.data, batch_size=batch_size, transform=self.transform,
                            load_images=self.load_images, shuffle=shuffle, seed=seed, **kwargs)


# Names kept for config compatibility with the reference's _target_ entries.
TipAdapterDataset = DatasetView


def NoImageDataset(dataset: str, split: str, root_path: str, shots: int = -1, **kwargs) -> DatasetView:
    kwargs.pop("load_images", None)
    return DatasetView(dataset, split, root_path, shots, load_images=False, **kwargs)
