"""The device rule of the port's library: the card unless the caller names another.

Every public function or class of ``methods/``, ``models/`` and ``engine/`` that
takes a ``device`` resolves it here, so a caller who names none runs on the
card, and without a card is told how to run on the CPU rather than put there.
"""

from __future__ import annotations

import typing as tp

import torch

__all__ = ["resolve_device"]

Device = tp.Union[None, str, torch.device]


def resolve_device(name: Device = None) -> torch.device:
    """``None``/``"auto"``: the card. Without one this raises: a run takes the
    CPU only when the caller names it (``device="cpu"``, ``meta.device=cpu``
    in an app's config)."""
    if name is None or (isinstance(name, str) and name == "auto"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device=\"cpu\" (meta.device=cpu in an "
                               "app's config) to run on the CPU")
        return torch.device("cuda")
    return torch.device(str(name)) if not isinstance(name, torch.device) else name
