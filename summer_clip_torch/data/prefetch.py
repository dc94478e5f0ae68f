"""Host -> device prefetch for :class:`summer_clip_torch.data.loader.Batch` streams.

Counterpart of ``summer_clip_tpu.data.loader.prefetch_to_device`` (which
imports jax): on CUDA each batch's images are copied into pinned host memory
and sent with a ``non_blocking`` copy on the current stream, ``size`` batches
ahead of the consumer. Labels, indices and the mask stay host numpy arrays,
so reading them never waits for the device. On CPU the images become a
tensor without a copy.

Spans (``core/profiling``): ``extract.load`` around each pull from the
iterator, ``extract.stage`` around each :func:`to_device`; both close before
the batch is yielded.
"""

from __future__ import annotations

import collections
import typing as tp

import numpy as np
import torch

from summer_clip_torch.core import profiling
from summer_clip_torch.data.loader import Batch

__all__ = ["to_device", "prefetch_to_device"]


def to_device(batch: Batch, device: torch.device) -> Batch:
    if batch.images is None:
        return batch
    images = torch.from_numpy(np.ascontiguousarray(batch.images))
    if device.type == "cuda":
        images = images.pin_memory().to(device, non_blocking=True)
    return batch._replace(images=images)


def prefetch_to_device(iterator: tp.Iterable[Batch], device: tp.Union[str, torch.device],
                       size: int = 2) -> tp.Iterator[Batch]:
    """Keep ``size`` batches in flight on ``device`` ahead of the consumer."""
    device = torch.device(device)
    queue: "collections.deque[Batch]" = collections.deque()
    batches = iter(iterator)
    while True:
        with profiling.span("extract.load"):
            batch = next(batches, None)
        if batch is None:
            break
        with profiling.span("extract.stage"):
            queue.append(to_device(batch, device))
        if len(queue) > size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
