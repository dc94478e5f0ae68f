"""The feature store the port reads and writes.

It is the JAX package's own ``FeatureStore`` (numpy and JSON, no jax), so the
catalog keys and (N, D) row layout are shared and either package reads what
the other wrote.
"""

from summer_clip_tpu.store import FeatureStore

__all__ = ["FeatureStore"]
