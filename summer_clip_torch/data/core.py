"""Dataset framework: Datum / DatasetBase / few-shot sampling / split IO.

Re-implementation of the reference's data contract
(``summer_clip/tip_adapter/datasets/utils.py``): datasets are lists of
``Datum(impath, label, classname)`` grouped into train_x/val/test splits,
with k-shot balanced subsampling and the ``split_zhou_*.json`` split-file
format shared by the CoOp/Tip-Adapter dataset distributions.

Differences by design (TPU-first framework):

- No torch Dataset/DataLoader: consumers iterate ``Datum`` lists and batch
  through :mod:`summer_clip_torch.data.loader`, which produces fixed-shape
  NHWC numpy batches for XLA.
- Few-shot sampling takes an explicit ``numpy.random.Generator`` so runs are
  reproducible without global seed mutation.
"""

from __future__ import annotations

import dataclasses
import json
import os
import typing as tp
from collections import defaultdict
from pathlib import Path

import numpy as np

__all__ = [
    "Datum", "DatasetBase", "read_json", "write_json", "listdir_nohidden",
    "read_split", "save_split", "split_trainval", "generate_fewshot",
]


@dataclasses.dataclass(frozen=True)
class Datum:
    """One labeled example; the image stays on disk until batching."""

    impath: str = ""
    label: int = 0
    domain: int = -1
    classname: str = ""


def read_json(path: tp.Union[str, Path]) -> tp.Any:
    with open(path) as f:
        return json.load(f)


def write_json(obj: tp.Any, path: tp.Union[str, Path]) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=4, separators=(",", ": "))


def listdir_nohidden(path: tp.Union[str, Path], sort: bool = True) -> tp.List[str]:
    items = [f for f in os.listdir(path) if not f.startswith(".")]
    if sort:
        items.sort()
    return items


# -- split files (split_zhou_<Dataset>.json interchange format) --------------

def read_split(filepath: tp.Union[str, Path],
               path_prefix: tp.Union[str, Path]) -> tp.Tuple[tp.List[Datum], tp.List[Datum], tp.List[Datum]]:
    """Read a CoOp-format split json: {split: [[relpath, label, classname]]}."""
    split = read_json(filepath)

    def convert(rows):
        return [
            Datum(impath=str(Path(path_prefix) / rel), label=int(label), classname=cname)
            for rel, label, cname in rows
        ]

    return convert(split["train"]), convert(split["val"]), convert(split["test"])


def save_split(train: tp.Sequence[Datum], val: tp.Sequence[Datum], test: tp.Sequence[Datum],
               filepath: tp.Union[str, Path], path_prefix: tp.Union[str, Path]) -> None:
    prefix = str(path_prefix)

    def extract(items):
        rows = []
        for it in items:
            rel = it.impath
            if rel.startswith(prefix):
                rel = rel[len(prefix):]
            rows.append((rel.lstrip("/"), it.label, it.classname))
        return rows

    write_json({"train": extract(train), "val": extract(val), "test": extract(test)}, filepath)


def split_trainval(trainval: tp.Sequence[Datum], p_val: float = 0.2,
                   rng: tp.Optional[np.random.Generator] = None) -> tp.Tuple[tp.List[Datum], tp.List[Datum]]:
    """Per-class random train/val split of a combined trainval list."""
    rng = rng or np.random.default_rng()
    by_label: tp.Dict[int, tp.List[int]] = defaultdict(list)
    for idx, item in enumerate(trainval):
        by_label[item.label].append(idx)

    train: tp.List[Datum] = []
    val: tp.List[Datum] = []
    for _, idxs in by_label.items():
        n_val = round(len(idxs) * p_val)
        assert n_val > 0, "every class needs at least one val sample"
        order = rng.permutation(len(idxs))
        for rank, pos in enumerate(order):
            (val if rank < n_val else train).append(trainval[idxs[pos]])
    return train, val


def generate_fewshot(data: tp.Sequence[Datum], num_shots: int, *,
                     repeat: bool = True,
                     rng: tp.Optional[np.random.Generator] = None) -> tp.List[Datum]:
    """Balanced k-shot subsample; classes with < k samples repeat (or keep all)."""
    if num_shots < 1:
        return list(data)
    rng = rng or np.random.default_rng()
    by_label: tp.Dict[int, tp.List[Datum]] = defaultdict(list)
    for item in data:
        by_label[item.label].append(item)

    out: tp.List[Datum] = []
    for _, items in by_label.items():
        if len(items) >= num_shots:
            picks = rng.choice(len(items), size=num_shots, replace=False)
        elif repeat:
            picks = rng.choice(len(items), size=num_shots, replace=True)
        else:
            picks = np.arange(len(items))
        out.extend(items[i] for i in picks)
    return out


class DatasetBase:
    """Split container with classname bookkeeping.

    Subclasses populate train_x/val/test with Datum lists and set
    ``template`` (list of prompt format strings).
    """

    dataset_dir = ""
    template: tp.List[str] = ["a photo of a {}."]

    def __init__(self, train_x: tp.Optional[tp.List[Datum]] = None,
                 train_u: tp.Optional[tp.List[Datum]] = None,
                 val: tp.Optional[tp.List[Datum]] = None,
                 test: tp.Optional[tp.List[Datum]] = None):
        self._train_x = train_x or []
        self._train_u = train_u
        self._val = val or []
        self._test = test or []
        self._num_classes = self.count_classes(self._train_x)
        self._lab2cname, self._classnames = self.build_lab2cname(self._train_x)

    train_x = property(lambda self: self._train_x)
    train_u = property(lambda self: self._train_u)
    val = property(lambda self: self._val)
    test = property(lambda self: self._test)
    num_classes = property(lambda self: self._num_classes)
    lab2cname = property(lambda self: self._lab2cname)
    classnames = property(lambda self: self._classnames)

    @staticmethod
    def count_classes(data: tp.Sequence[Datum]) -> int:
        return (max(it.label for it in data) + 1) if data else 0

    @staticmethod
    def build_lab2cname(data: tp.Sequence[Datum]) -> tp.Tuple[tp.Dict[int, str], tp.List[str]]:
        mapping = {it.label: it.classname for it in data}
        labels = sorted(mapping)
        return mapping, [mapping[l] for l in labels]

    def generate_fewshot_dataset(self, data: tp.Sequence[Datum], num_shots: int = -1,
                                 repeat: bool = True,
                                 rng: tp.Optional[np.random.Generator] = None) -> tp.List[Datum]:
        return generate_fewshot(data, num_shots, repeat=repeat, rng=rng)

    @staticmethod
    def split_dataset_by_label(data: tp.Sequence[Datum]) -> tp.Dict[int, tp.List[Datum]]:
        out: tp.Dict[int, tp.List[Datum]] = defaultdict(list)
        for item in data:
            out[item.label].append(item)
        return out

    def download_data(self, url: str, dst: tp.Union[str, Path],
                      from_gdrive: bool = True) -> None:
        """Fetch + extract a dataset archive (reference
        ``tip_adapter/datasets/utils.py:188-209``). Google-Drive URLs need the
        optional ``gdown`` package; plain URLs use urllib. The archive is
        extracted next to ``dst`` (tar first, zip fallback)."""
        dst = Path(dst)
        dst.parent.mkdir(parents=True, exist_ok=True)
        if from_gdrive:
            try:
                import gdown  # type: ignore
            except ImportError as e:
                raise RuntimeError(
                    "gdown is required for Google-Drive downloads; install it "
                    "or place the extracted dataset under the dataset root "
                    "manually") from e
            gdown.download(url, str(dst), quiet=False)
        else:
            import urllib.request

            urllib.request.urlretrieve(url, dst)
        self.extract_archive(dst)

    @staticmethod
    def extract_archive(archive: tp.Union[str, Path]) -> Path:
        """Extract a tar/zip archive into its parent directory."""
        import tarfile
        import zipfile

        archive = Path(archive)
        target = archive.parent
        if tarfile.is_tarfile(archive):
            with tarfile.open(archive) as tar:
                tar.extractall(path=target, filter="data")
        elif zipfile.is_zipfile(archive):
            with zipfile.ZipFile(archive) as zf:
                zf.extractall(target)
        else:
            raise ValueError(f"Unrecognized archive format: {archive}")
        return target
