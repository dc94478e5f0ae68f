"""CLIP image preprocessing in numpy/PIL, producing NHWC float32 for XLA.

Matches the torchvision pipeline the reference uses (CLIP's ``preprocess``:
bicubic resize -> center crop -> normalize; train augmentation:
RandomResizedCrop(0.5-1.0, bicubic) + horizontal flip — cf.
``summer_clip/tip_adapter/tip_adapter.py:32-38``), but implemented on PIL +
numpy so decode/augment runs on host CPU threads while the TPU consumes
fixed-shape NHWC batches.
"""

from __future__ import annotations

import typing as tp

import numpy as np
from PIL import Image

__all__ = [
    "CLIP_MEAN", "CLIP_STD", "load_image", "eval_transform", "train_transform",
    "EvalTransform", "TrainTransform",
]

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def load_image(path: str, retries: int = 5) -> Image.Image:
    """Robust PIL loader with IO retry (shared-filesystem flakiness guard)."""
    err: tp.Optional[Exception] = None
    for _ in range(retries):
        try:
            img = Image.open(path)
            return img.convert("RGB")
        except OSError as e:  # pragma: no cover - io flake path
            err = e
    raise OSError(f"Failed to read image after {retries} attempts: {path}") from err


def _normalize(arr: np.ndarray) -> np.ndarray:
    return (arr - CLIP_MEAN) / CLIP_STD


def _to_float_hwc(img: Image.Image) -> np.ndarray:
    return np.asarray(img, np.float32) / 255.0


def _center_crop(img: Image.Image, size: int) -> Image.Image:
    w, h = img.size
    left = (w - size) // 2
    top = (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def _resize_shorter(img: Image.Image, size: int) -> Image.Image:
    w, h = img.size
    if w <= h:
        nw, nh = size, max(1, round(h * size / w))
    else:
        nw, nh = max(1, round(w * size / h)), size
    return img.resize((nw, nh), Image.BICUBIC)


class EvalTransform:
    """CLIP eval preprocess: resize(shorter->S, bicubic), center crop S, normalize.

    ``device_normalize=True`` emits uint8 HWC instead of normalized float32:
    the /255 + mean/std normalization then runs on-device inside the jitted
    encode (ClipSession), cutting host->device transfer 4x. Same math, same
    order — results match the float path to f32 rounding.
    """

    def __init__(self, input_size: int = 224, device_normalize: bool = False):
        self.input_size = input_size
        self.device_normalize = device_normalize

    def __call__(self, img: Image.Image, rng: tp.Optional[np.random.Generator] = None) -> np.ndarray:
        img = _resize_shorter(img, self.input_size)
        img = _center_crop(img, self.input_size)
        if self.device_normalize:
            return np.ascontiguousarray(np.asarray(img, np.uint8))
        return _normalize(_to_float_hwc(img))


class TrainTransform:
    """RandomResizedCrop(scale, bicubic) + random horizontal flip + normalize."""

    def __init__(self, input_size: int = 224,
                 scale: tp.Tuple[float, float] = (0.5, 1.0),
                 ratio: tp.Tuple[float, float] = (3 / 4, 4 / 3),
                 hflip_p: float = 0.5, device_normalize: bool = False):
        self.input_size = input_size
        self.scale = scale
        self.ratio = ratio
        self.hflip_p = hflip_p
        self.device_normalize = device_normalize

    def __call__(self, img: Image.Image, rng: tp.Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        w, h = img.size
        area = w * h
        crop = None
        for _ in range(10):
            target_area = area * rng.uniform(*self.scale)
            log_ratio = np.log(self.ratio)
            aspect = float(np.exp(rng.uniform(log_ratio[0], log_ratio[1])))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                left = int(rng.integers(0, w - cw + 1))
                top = int(rng.integers(0, h - ch + 1))
                crop = (left, top, left + cw, top + ch)
                break
        if crop is None:  # central fallback, torchvision-style
            in_ratio = w / h
            if in_ratio < self.ratio[0]:
                cw, ch = w, int(round(w / self.ratio[0]))
            elif in_ratio > self.ratio[1]:
                cw, ch = int(round(h * self.ratio[1])), h
            else:
                cw, ch = w, h
            left, top = (w - cw) // 2, (h - ch) // 2
            crop = (left, top, left + cw, top + ch)

        img = img.resize((self.input_size, self.input_size), Image.BICUBIC, box=crop)
        if self.device_normalize:
            arr8 = np.asarray(img, np.uint8)
            if rng.random() < self.hflip_p:
                arr8 = arr8[:, ::-1, :]
            return np.ascontiguousarray(arr8)
        arr = _to_float_hwc(img)
        if rng.random() < self.hflip_p:
            arr = arr[:, ::-1, :]
        return _normalize(np.ascontiguousarray(arr))


def eval_transform(input_size: int = 224) -> EvalTransform:
    return EvalTransform(input_size)


def train_transform(input_size: int = 224, **kwargs) -> TrainTransform:
    return TrainTransform(input_size, **kwargs)
