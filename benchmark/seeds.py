"""Sub-seeds of a run's ``--seed``: each stream of random numbers (weights,
images, features, samples of the check) has its own, so adding one stream
moves no other."""

from __future__ import annotations

import hashlib


def derive(seed: int, *tags: str) -> int:
    """A 63-bit seed for the stream named by ``tags`` under ``seed`` (any
    whole number, however large)."""
    digest = hashlib.sha256(":".join([str(int(seed)), *tags]).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1
