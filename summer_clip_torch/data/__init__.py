"""Data layer of the port: device prefetch and the datasets it registers.
Datasets, views, batchers and transforms are the JAX package's own
(``summer_clip_tpu.data``, which imports no jax)."""

from summer_clip_torch.data import datasets  # noqa: F401  (registers synthetic_1k)
from summer_clip_torch.data.prefetch import prefetch_to_device, to_device  # noqa: F401
