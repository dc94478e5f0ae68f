"""The 11 classification datasets + registry (CoOp/Tip-Adapter family).

Covers the loaders in the reference's ``summer_clip/tip_adapter/datasets/``
(SURVEY.md §2.4): per-dataset split readers, hand-written prompt templates,
classname normalizations (EuroSAT remap, SUN397 hierarchy reversal,
StanfordCars year-fronting, UCF101 camel-case splitting), and the shared
``split_zhou_*.json`` interchange format. All rewritten on the numpy/Datum
data layer; on-disk layouts are identical to the public dataset
distributions so existing downloads work unchanged.

A ``synthetic`` dataset is registered for tests/benchmarks: deterministic
procedurally-generated images, no disk layout required.
"""

from __future__ import annotations

import json
import re
import typing as tp

from pathlib import Path

import numpy as np

from summer_clip_torch.data.core import (
    Datum, DatasetBase, listdir_nohidden, read_json, read_split,
)

__all__ = ["build_dataset", "DATASET_REGISTRY", "register_dataset", "SyntheticDataset"]

DATASET_REGISTRY: tp.Dict[str, tp.Callable[..., DatasetBase]] = {}


def register_dataset(name: str):
    def deco(cls):
        DATASET_REGISTRY[name] = cls
        return cls
    return deco


def build_dataset(dataset: str, root_path: str, shots: int, **kwargs) -> DatasetBase:
    """Registry entry point (reference ``datasets/__init__.py:27-28``)."""
    return DATASET_REGISTRY[dataset](root_path, shots, **kwargs)


class _SplitJsonDataset(DatasetBase):
    """Common shape: images dir + split_zhou json + few-shot train subsample."""

    dataset_dir = ""
    image_subdir = "images"
    split_name = ""
    template = ["a photo of a {}."]

    def __init__(self, root: str, num_shots: int,
                 rng: tp.Optional[np.random.Generator] = None):
        base = Path(root) / self.dataset_dir
        self.image_dir = str(base / self.image_subdir)
        self.split_path = str(base / self.split_name)
        train, val, test = read_split(self.split_path, self.image_dir)
        train = [self.fix_item(i) for i in train]
        val = [self.fix_item(i) for i in val]
        test = [self.fix_item(i) for i in test]
        train = self.generate_fewshot_dataset(train, num_shots=num_shots, rng=rng)
        super().__init__(train_x=train, val=val, test=test)

    def fix_item(self, item: Datum) -> Datum:
        return item


@register_dataset("caltech101")
class Caltech101(_SplitJsonDataset):
    dataset_dir = "caltech-101"
    image_subdir = "101_ObjectCategories"
    split_name = "split_zhou_Caltech101.json"
    template = ["a photo of a {}."]


@register_dataset("oxford_pets")
class OxfordPets(_SplitJsonDataset):
    dataset_dir = "oxford_pets"
    image_subdir = "images"
    split_name = "split_zhou_OxfordPets.json"
    template = ["a photo of a {}, a type of pet."]


@register_dataset("food101")
class Food101(_SplitJsonDataset):
    dataset_dir = "food-101"
    image_subdir = "images"
    split_name = "split_zhou_Food101.json"
    template = ["a photo of {}, a type of food."]


@register_dataset("oxford_flowers")
class OxfordFlowers(_SplitJsonDataset):
    dataset_dir = "oxford_flowers"
    image_subdir = "jpg"
    split_name = "split_zhou_OxfordFlowers.json"
    template = ["a photo of a {}, a type of flower."]


@register_dataset("dtd")
class DescribableTextures(_SplitJsonDataset):
    dataset_dir = "dtd"
    image_subdir = "images"
    split_name = "split_zhou_DescribableTextures.json"
    template = ["{} texture."]


@register_dataset("sun397")
class SUN397(_SplitJsonDataset):
    dataset_dir = "sun397"
    image_subdir = "SUN397"
    split_name = "split_zhou_SUN397.json"
    template = ["a photo of a {}."]


@register_dataset("ucf101")
class UCF101(_SplitJsonDataset):
    dataset_dir = "ucf101"
    image_subdir = "UCF-101-midframes"
    split_name = "split_zhou_UCF101.json"
    template = ["a photo of a person doing {}."]

    @staticmethod
    def camel_to_words(action: str) -> str:
        return "_".join(re.findall("[A-Z][^A-Z]*", action))


@register_dataset("stanford_cars")
class StanfordCars(_SplitJsonDataset):
    dataset_dir = "stanford_cars"
    image_subdir = ""
    split_name = "split_zhou_StanfordCars.json"
    template = ["a photo of a {}."]


EUROSAT_CNAMES = {
    "AnnualCrop": "Annual Crop Land",
    "Forest": "Forest",
    "HerbaceousVegetation": "Herbaceous Vegetation Land",
    "Highway": "Highway or Road",
    "Industrial": "Industrial Buildings",
    "Pasture": "Pasture Land",
    "PermanentCrop": "Permanent Crop Land",
    "Residential": "Residential Buildings",
    "River": "River",
    "SeaLake": "Sea or Lake",
}


@register_dataset("eurosat")
class EuroSAT(_SplitJsonDataset):
    dataset_dir = "eurosat"
    image_subdir = "2750"
    split_name = "split_zhou_EuroSAT.json"
    template = ["a centered satellite photo of {}."]

    def fix_item(self, item: Datum) -> Datum:
        new_name = EUROSAT_CNAMES.get(item.classname, item.classname)
        if new_name != item.classname:
            return Datum(item.impath, item.label, item.domain, new_name)
        return item


@register_dataset("fgvc")
class FGVCAircraft(DatasetBase):
    dataset_dir = "fgvc_aircraft"
    template = ["a photo of a {}, a type of aircraft."]

    def __init__(self, root: str, num_shots: int,
                 rng: tp.Optional[np.random.Generator] = None):
        base = Path(root) / self.dataset_dir
        self.image_dir = str(base / "images")
        classnames = [l.strip() for l in open(base / "variants.txt") if l.strip()]
        cname2lab = {c: i for i, c in enumerate(classnames)}
        splits = {
            s: self._read(base, cname2lab, f"images_variant_{s}.txt") for s in ("train", "val", "test")
        }
        train = self.generate_fewshot_dataset(splits["train"], num_shots=num_shots, rng=rng)
        super().__init__(train_x=train, val=splits["val"], test=splits["test"])

    def _read(self, base: Path, cname2lab: tp.Dict[str, int], fname: str) -> tp.List[Datum]:
        items = []
        for line in open(base / fname):
            parts = line.strip().split(" ")
            if not parts or not parts[0]:
                continue
            imname, classname = parts[0], " ".join(parts[1:])
            items.append(Datum(
                impath=str(Path(self.image_dir) / f"{imname}.jpg"),
                label=cname2lab[classname], classname=classname,
            ))
        return items


def _imagenet_assets() -> tp.Tuple[tp.List[str], tp.List[str]]:
    asset = Path(__file__).parent / "assets" / "imagenet.json"
    data = json.loads(asset.read_text())
    return data["classnames"], data["templates"]


@register_dataset("imagenet")
class ImageNetDataset(DatasetBase):
    """ImageNet from the standard torchvision directory layout.

    Expects ``<root>/imagenet/{train,val}/<wnid>/*.JPEG``. Class names come
    from the curated OpenAI table (data asset), ordered by sorted wnid —
    the same ordering torchvision's ImageNet produces.
    """

    dataset_dir = "imagenet"

    def __init__(self, root: str, num_shots: int,
                 rng: tp.Optional[np.random.Generator] = None):
        base = Path(root) / self.dataset_dir
        if not base.exists():
            base = Path(root)
        classnames, templates = _imagenet_assets()
        self.template = templates

        split_wnids: tp.Dict[str, tp.List[str]] = {}

        def read_dir(split: str) -> tp.List[Datum]:
            split_dir = base / split
            items: tp.List[Datum] = []
            if not split_dir.exists():
                return items
            wnids = split_wnids[split] = listdir_nohidden(split_dir)
            # Labels are positional over sorted wnids (torchvision ordering;
            # reference pins the 1000 names explicitly, imagenet.py:11-175).
            # A missing/extra class dir would silently shift every later
            # label — fail loudly instead.
            if len(wnids) != len(classnames):
                raise ValueError(
                    f"ImageNet {split} split at {split_dir} has {len(wnids)} class "
                    f"dirs but the curated classname table has {len(classnames)}; "
                    "positional wnid->classname mapping would mislabel every class "
                    "after the first mismatch. Fix the dataset directory (or point "
                    "root at a full copy).")
            for label, wnid in enumerate(wnids):
                cname = classnames[label]
                for img in listdir_nohidden(split_dir / wnid):
                    items.append(Datum(
                        impath=str(split_dir / wnid / img), label=label, classname=cname,
                    ))
            return items

        train = read_dir("train")
        val = read_dir("val")
        # NOTE: this catches count mismatches and train/val disagreement; a
        # same-count wnid SUBSTITUTION present in both splits is still
        # undetectable without a pinned wnid list (the curated table pins
        # names by position, not by wnid).
        if ("train" in split_wnids and "val" in split_wnids
                and split_wnids["train"] != split_wnids["val"]):
            raise ValueError(
                "ImageNet train/ and val/ wnid directory sets differ — labels "
                "would disagree between splits.")
        train = self.generate_fewshot_dataset(train, num_shots=num_shots, rng=rng)
        ds = super().__init__(train_x=train, val=val, test=val)
        if not self._classnames:
            self._classnames = classnames
        del ds


@register_dataset("synthetic")
class SyntheticDataset(DatasetBase):
    """Procedural dataset for tests/benchmarks — no files needed.

    Each Datum's ``impath`` encodes ``synthetic://<seed>`` and images are
    rendered deterministically by :meth:`render`.
    """

    template = ["a photo of a {}."]

    def __init__(self, root: str = "", num_shots: int = -1, *,
                 num_classes: int = 4, per_class: int = 8, image_size: int = 32,
                 rng: tp.Optional[np.random.Generator] = None):
        self.image_size = image_size
        self.num_classes_cfg = num_classes

        def make(split_tag: str, count: int) -> tp.List[Datum]:
            items = []
            for c in range(num_classes):
                for i in range(count):
                    items.append(Datum(
                        impath=f"synthetic://{split_tag}/{c}/{i}",
                        label=c, classname=f"class {c}",
                    ))
            return items

        train = make("train", per_class)
        val = make("val", max(1, per_class // 2))
        test = make("test", max(1, per_class // 2))
        train = self.generate_fewshot_dataset(train, num_shots=num_shots, rng=rng)
        super().__init__(train_x=train, val=val, test=test)

    @staticmethod
    def render(impath: str, image_size: int = 32) -> np.ndarray:
        seed = abs(hash(impath)) % (2 ** 31)
        rng = np.random.default_rng(seed)
        return rng.standard_normal((image_size, image_size, 3)).astype(np.float32)


class SyntheticBatcher:
    """Batcher over SyntheticDataset items (images rendered, not decoded)."""

    def __init__(self, data: tp.Sequence[Datum], batch_size: int = 8, image_size: int = 32):
        self.data = list(data)
        self.batch_size = batch_size
        self.image_size = image_size

    def __len__(self):
        return -(-len(self.data) // self.batch_size)

    def __iter__(self):
        from summer_clip_torch.data.loader import Batch, pad_to_batch

        bs = self.batch_size
        for s in range(0, len(self.data), bs):
            chunk = self.data[s:s + bs]
            imgs = np.stack([SyntheticDataset.render(i.impath, self.image_size) for i in chunk])
            labels = np.asarray([i.label for i in chunk], np.int32)
            idx = np.arange(s, s + len(chunk), dtype=np.int32)
            mask = np.ones(len(chunk), bool)
            yield Batch(pad_to_batch(imgs, bs), pad_to_batch(labels, bs),
                        pad_to_batch(idx, bs), pad_to_batch(mask, bs))


@register_dataset("synthetic_1k")
class SyntheticImageNetScale(SyntheticDataset):
    """The procedural ``synthetic`` dataset at ImageNet's class count (1000
    classes; 2 train, 1 val and 1 test image per class). Only the port has it.
    A 1-shot Tip cache over it spans 1000 classes in one cache block, which
    routes the sweep to the label-built dense kernel (K2) exactly as a 1-shot
    ImageNet cache does; the 4-class ``synthetic`` cache takes the
    class-grouped kernel (K3)."""

    def __init__(self, root: str = "", num_shots: int = -1, *,
                 rng: tp.Optional[np.random.Generator] = None):
        super().__init__(root, num_shots, num_classes=1000, per_class=2, rng=rng)


@register_dataset("imagenetv2")
class ImageNetV2Dataset(DatasetBase):
    """ImageNetV2 (matched-frequency) from its public directory format.

    Layout: ``<root>/imagenetv2-matched-frequency-format-val/<class_idx>/*.jpeg``
    with 0-999 class-index directory names; class names come from the curated
    OpenAI table (reference wraps ``imagenetv2_pytorch``; eval_adapter
    ImageNetV2 baselines in SURVEY.md §6).
    """

    dataset_dir = "imagenetv2-matched-frequency-format-val"

    def __init__(self, root: str, num_shots: int = -1,
                 rng: tp.Optional[np.random.Generator] = None):
        base = Path(root) / self.dataset_dir
        if not base.exists():
            base = Path(root)
        classnames, templates = _imagenet_assets()
        self.template = templates
        items: tp.List[Datum] = []
        class_dirs = sorted((d for d in base.iterdir() if d.is_dir()),
                            key=lambda d: int(d.name)) if base.exists() else []
        for d in class_dirs:
            label = int(d.name)
            cname = classnames[label] if label < len(classnames) else d.name
            for img in listdir_nohidden(d):
                items.append(Datum(impath=str(d / img), label=label, classname=cname))
        super().__init__(train_x=items, val=items, test=items)
        if not self._classnames:
            self._classnames = classnames
