"""Host input pipeline: threaded decode/augment -> fixed-shape NHWC batches.

Copy of ``summer_clip_tpu/data/loader.py`` (numpy + PIL), replacing the
reference's torch DataLoader worker processes
(``tip_adapter/datasets/utils.py:356-380``):

- a thread pool decodes JPEGs / applies numpy transforms while the device runs,
- every batch has the **same static shape** (the tail batch is padded and a
  validity mask returned),
- :func:`summer_clip_torch.data.prefetch.prefetch_to_device` keeps N batches
  in flight on the accelerator.

Two differences from the JAX package's module: the native C++ JPEG decoder is
not ported (``use_native`` is accepted and the PIL path always runs), and
``prefetch_to_device`` lives in :mod:`summer_clip_torch.data.prefetch`.

The label-only fast path (reference ``NoImageImageNetDataset`` /
``load_images=False``) never touches image bytes.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import typing as tp

import numpy as np

from summer_clip_torch.data.core import Datum
from summer_clip_torch.data.transforms import CLIP_MEAN, CLIP_STD, EvalTransform, load_image

__all__ = ["Batch", "ImageBatcher", "labels_of", "pad_to_batch"]


class Batch(tp.NamedTuple):
    images: tp.Optional[np.ndarray]   # (B, H, W, 3) float32 normalized, or uint8
                                      # raw (device_normalize), or None (label-only)
    labels: np.ndarray                # (B,) int32
    indices: np.ndarray               # (B,) int32 — position in the dataset
    mask: np.ndarray                  # (B,) bool — False on tail padding


def labels_of(data: tp.Sequence[Datum]) -> np.ndarray:
    """Gold labels of a split as one int32 array (reference load_labels)."""
    return np.asarray([it.label for it in data], np.int32)


def pad_to_batch(arr: np.ndarray, batch_size: int) -> np.ndarray:
    if arr.shape[0] == batch_size:
        return arr
    pad = [(0, batch_size - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


class ImageBatcher:
    """Iterates fixed-shape batches over a Datum list.

    Decoding is overlapped: the next batch's images decode on a thread pool
    while the caller consumes the current one.
    """

    def __init__(self, data: tp.Sequence[Datum], batch_size: int = 256,
                 transform: tp.Optional[tp.Callable] = None,
                 load_images: bool = True, shuffle: bool = False,
                 seed: int = 0, num_threads: int = 16,
                 drop_last: bool = False, use_native: tp.Optional[bool] = None,
                 k_tfm: int = 1, native_fast: bool = False):
        self.data = list(data)
        self.batch_size = batch_size
        self.transform = transform or EvalTransform()
        self.load_images = load_images
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = num_threads
        self.drop_last = drop_last
        # k_tfm > 1: decode once, apply the (stochastic) transform k times and
        # stack -> (B, K, H, W, 3) multi-view batches (reference DatasetWrapper
        # k_tfm, tip_adapter/datasets/utils.py:315-341)
        if k_tfm < 1:
            raise ValueError(f"k_tfm must be >= 1, got {k_tfm}")
        if k_tfm > 1 and transform is None:
            raise ValueError(f"Cannot augment the image {k_tfm} times because transform is None")
        self.k_tfm = k_tfm
        self._epoch = 0
        # native C++ decode path: eval transform over JPEG files only
        if use_native is None:
            use_native = (
                type(self.transform).__name__ == "EvalTransform"
                and bool(self.data)
                and self.data[0].impath.lower().endswith((".jpg", ".jpeg"))
            )
        self.use_native = bool(use_native) and self.k_tfm == 1 and self._native_available()
        # fast=True: relaxed DCT-scale margin (1x instead of 2x the target
        # short side) - ~2x decode throughput for typical source sizes at a
        # small quality cost (native.preprocess_batch docstring); default
        # off so the PIL-parity reference path stays the default
        self.native_fast = bool(native_fast)

    @staticmethod
    def _native_available() -> bool:
        return False   # the native decoder is not ported: PIL decodes every batch

    def __len__(self) -> int:
        n = len(self.data)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _order(self) -> np.ndarray:
        if not self.shuffle:
            return np.arange(len(self.data))
        rng = np.random.default_rng((self.seed, self._epoch))
        return rng.permutation(len(self.data))

    def _decode_one(self, ds_index: int, aug_seed: int) -> np.ndarray:
        item = self.data[ds_index]
        if item.impath.startswith("synthetic://"):
            from summer_clip_torch.data.datasets import SyntheticDataset

            size = getattr(self.transform, "input_size", 32)
            img = SyntheticDataset.render(item.impath, size)
            if self.k_tfm > 1:
                return np.stack([img] * self.k_tfm)
            return img
        if item.impath.startswith("array://"):
            from PIL import Image

            from summer_clip_torch.data.array_datasets import resolve_array_image

            img = Image.fromarray(resolve_array_image(item.impath))
        else:
            img = load_image(item.impath)
        if self.k_tfm == 1:
            rng = np.random.default_rng((self.seed, self._epoch, aug_seed))
            return self.transform(img, rng)
        views = [
            self.transform(img, np.random.default_rng((self.seed, self._epoch, aug_seed, k)))
            for k in range(self.k_tfm)
        ]
        return np.stack(views)

    def __iter__(self) -> tp.Iterator[Batch]:
        order = self._order()
        n = len(order)
        bs = self.batch_size
        starts = list(range(0, n - bs + 1, bs)) if self.drop_last else list(range(0, n, bs))

        if not self.load_images:
            for s in starts:
                idx = order[s:s + bs]
                labels = np.asarray([self.data[i].label for i in idx], np.int32)
                mask = np.ones(len(idx), bool)
                yield Batch(
                    None,
                    pad_to_batch(labels, bs),
                    pad_to_batch(idx.astype(np.int32), bs),
                    pad_to_batch(mask, bs),
                )
            return

        def make_batch(s: int, pool: cf.ThreadPoolExecutor) -> "cf.Future":
            idx = order[s:s + bs]

            def build() -> Batch:
                with cf.ThreadPoolExecutor(max_workers=min(self.num_threads, max(1, len(idx)))) as inner:
                    imgs = list(inner.map(self._decode_one, idx, [int(i) for i in idx]))
                images = np.stack(imgs)
                if images.dtype != np.uint8:  # device_normalize ships raw bytes
                    images = images.astype(np.float32)
                labels = np.asarray([self.data[i].label for i in idx], np.int32)
                mask = np.ones(len(idx), bool)
                return Batch(
                    pad_to_batch(images, bs),
                    pad_to_batch(labels, bs),
                    pad_to_batch(idx.astype(np.int32), bs),
                    pad_to_batch(mask, bs),
                )

            return pool.submit(build)

        with cf.ThreadPoolExecutor(max_workers=2) as pool:
            pending: "collections.deque[cf.Future]" = collections.deque()
            for s in starts[:2]:
                pending.append(make_batch(s, pool))
            next_start = min(2, len(starts))
            while pending:
                batch = pending.popleft().result()
                if next_start < len(starts):
                    pending.append(make_batch(starts[next_start], pool))
                    next_start += 1
                yield batch
