"""The one generator of the benchmark's inputs, read from a cell's traffic
parameters (``workloads/<cell>.json``, key ``traffic``). Everything is drawn
on the device from a sub-seed of ``--seed``, in a few large calls.

- ``image_pool``: uint8 RGB images, a pool that extraction splits cycle
  through.
- ``class_structured``: features with class structure (a unit mean a class,
  plus noise), so accuracies lie far from chance and differ over a grid;
  labels in an order drawn from the seed, the same count of rows a class.
- ``pseudo_outs``: zero-shot outputs (cosine-like scores) for a cache whose
  top class is the true class for a given share of rows and another class
  for the rest.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from benchmark import seeds


def generator(seed: int, tag: str, device: tp.Union[str, torch.device]) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seeds.derive(seed, "traffic", tag))


def image_pool(seed: int, count: int, size: int, device) -> np.ndarray:
    """(count, size, size, 3) uint8 images on the host: smooth colour fields
    (a coarse grid upsampled) with pixel noise."""
    gen = generator(seed, "images", device)
    coarse = torch.rand(count, 3, 8, 8, generator=gen, device=device) * 255.0
    smooth = torch.nn.functional.interpolate(coarse, size=(size, size), mode="bilinear",
                                             align_corners=False)
    noise = torch.randn(count, 3, size, size, generator=gen, device=device) * 24.0
    img = (smooth + noise).clamp_(0, 255).round_().to(torch.uint8)
    return img.permute(0, 2, 3, 1).contiguous().cpu().numpy()


def unit_rows(gen: torch.Generator, n: int, d: int, device) -> torch.Tensor:
    z = torch.randn(n, d, generator=gen, device=device)
    return z / z.norm(dim=1, keepdim=True)


def balanced_labels(gen: torch.Generator, classes: int, per_class: int, device,
                    shuffle: bool = True) -> torch.Tensor:
    labels = torch.arange(classes, device=device).repeat_interleave(per_class)
    if shuffle:
        labels = labels[torch.randperm(labels.shape[0], generator=gen, device=device)]
    return labels


def class_structured(gen: torch.Generator, means: torch.Tensor, labels: torch.Tensor,
                     noise: float, shared: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    """``shared + means[label] + noise * z / sqrt(D)`` a row (float32, not
    normalized): a row's cosine to its class mean is about
    ``1 / sqrt(1 + noise^2)`` without ``shared``; a direction every row shares
    (CLIP's features have one) raises every cosine alike."""
    d = means.shape[1]
    z = torch.randn(labels.shape[0], d, generator=gen, device=means.device)
    rows = means[labels] + noise * z / d ** 0.5
    return rows if shared is None else rows + shared


def pseudo_outs(gen: torch.Generator, labels: torch.Tensor, classes: int, *, base: float,
                spread: float, margin: float, correct_share: float) -> torch.Tensor:
    """(N, C) cosine-like zero-shot scores: ``base + spread * z``, with
    ``margin`` added at the pseudo-label, the true label for
    ``correct_share`` of the rows and a label drawn at random otherwise."""
    n = labels.shape[0]
    outs = base + spread * torch.randn(n, classes, generator=gen, device=labels.device)
    wrong = torch.rand(n, generator=gen, device=labels.device) >= correct_share
    other = torch.randint(0, classes, (n,), generator=gen, device=labels.device)
    pseudo = torch.where(wrong, other, labels)
    outs[torch.arange(n, device=labels.device), pseudo] += margin
    return outs
