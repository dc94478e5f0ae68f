"""Array-backed datasets: CIFAR-10/100 and MNIST from their standard files.

The reference reaches these through torchvision ``_target_``s
(``conf/dataset/`` cifar/mnist variants, used by the train_adapter/
eval_adapter baselines — SURVEY.md §6 baselines are MNIST/CIFAR/ImageNet).
Here the standard on-disk archives are read directly (pickle batches for
CIFAR, idx-ubyte for MNIST) into uint8 arrays; Datums carry virtual
``array://`` paths resolved by the batcher without touching PIL decode.
"""

from __future__ import annotations

import gzip
import pickle
import struct
import typing as tp
from pathlib import Path

import numpy as np

from summer_clip_torch.data.core import Datum, DatasetBase
from summer_clip_torch.data.datasets import register_dataset

__all__ = ["ArrayBackedDataset", "CIFAR10", "CIFAR100", "MNIST", "resolve_array_image"]

_ARRAY_SOURCES: tp.Dict[int, "ArrayBackedDataset"] = {}


def resolve_array_image(impath: str) -> np.ndarray:
    """Resolve an ``array://<source>/<split>/<idx>`` path to a uint8 HWC image."""
    _, _, rest = impath.partition("array://")
    source_id, split, idx = rest.split("/")
    return _ARRAY_SOURCES[int(source_id)].image_of(split, int(idx))


class ArrayBackedDataset(DatasetBase):
    """DatasetBase whose images live in memory as uint8 arrays."""

    def __init__(self, splits: tp.Dict[str, tp.Tuple[np.ndarray, np.ndarray]],
                 classnames: tp.Sequence[str], num_shots: int = -1,
                 rng: tp.Optional[np.random.Generator] = None):
        self._images = {s: imgs for s, (imgs, _) in splits.items()}
        self._source_id = id(self)
        _ARRAY_SOURCES[self._source_id] = self
        self._class_list = list(classnames)

        def make(split: str) -> tp.List[Datum]:
            if split not in splits:
                return []
            _, labels = splits[split]
            return [
                Datum(impath=f"array://{self._source_id}/{split}/{i}",
                      label=int(l), classname=self._class_list[int(l)])
                for i, l in enumerate(labels)
            ]

        train = self.generate_fewshot_dataset(make("train"), num_shots=num_shots, rng=rng)
        test = make("test")
        val = make("val") or test
        super().__init__(train_x=train, val=val, test=test)
        if not self._classnames:
            self._classnames = self._class_list

    def image_of(self, split: str, idx: int) -> np.ndarray:
        return self._images[split][idx]


@register_dataset("cifar10")
class CIFAR10(ArrayBackedDataset):
    """Reads the standard ``cifar-10-batches-py`` pickle archive layout."""

    template = ["a photo of a {}."]
    archive_dir = "cifar-10-batches-py"
    train_files = [f"data_batch_{i}" for i in range(1, 6)]
    test_files = ["test_batch"]
    meta_file, meta_key = "batches.meta", b"label_names"
    label_key = b"labels"

    def __init__(self, root: str, num_shots: int = -1,
                 rng: tp.Optional[np.random.Generator] = None):
        base = Path(root) / self.archive_dir
        if not base.exists():
            base = Path(root)

        def read(files):
            imgs, labels = [], []
            for name in files:
                with open(base / name, "rb") as f:
                    d = pickle.load(f, encoding="bytes")
                data = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
                imgs.append(np.ascontiguousarray(data, np.uint8))
                labels.append(np.asarray(d[self.label_key], np.int64))
            return np.concatenate(imgs), np.concatenate(labels)

        with open(base / self.meta_file, "rb") as f:
            meta = pickle.load(f, encoding="bytes")
        classnames = [c.decode() for c in meta[self.meta_key]]
        splits = {"train": read(self.train_files), "test": read(self.test_files)}
        super().__init__(splits, classnames, num_shots=num_shots, rng=rng)


@register_dataset("cifar100")
class CIFAR100(CIFAR10):
    archive_dir = "cifar-100-python"
    train_files = ["train"]
    test_files = ["test"]
    meta_file, meta_key = "meta", b"fine_label_names"
    label_key = b"fine_labels"


def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:  # type: ignore[arg-type]
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


@register_dataset("mnist")
class MNIST(ArrayBackedDataset):
    """Reads the idx-ubyte files (optionally .gz) from the standard layout."""

    template = ['a photo of the number: "{}".']

    def __init__(self, root: str, num_shots: int = -1,
                 rng: tp.Optional[np.random.Generator] = None):
        base = Path(root) / "MNIST" / "raw"
        if not base.exists():
            base = Path(root)

        def find(stem: str) -> Path:
            for suffix in ("", ".gz"):
                p = base / f"{stem}{suffix}"
                if p.exists():
                    return p
            raise FileNotFoundError(f"{stem} not found under {base}")

        def read(split_stem: str, label_stem: str):
            imgs = _read_idx(find(split_stem))  # (N, 28, 28)
            labels = _read_idx(find(label_stem)).astype(np.int64)
            rgb = np.repeat(imgs[..., None], 3, axis=-1)
            return rgb, labels

        splits = {
            "train": read("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
            "test": read("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
        }
        classnames = [str(i) for i in range(10)]
        super().__init__(splits, classnames, num_shots=num_shots, rng=rng)
