"""Trainable adapters over frozen CLIP features.

Counterpart of ``summer_clip_tpu/methods/adapters.py``:

- :class:`LinearAdapter` -- one linear head (vision and/or text);
- :class:`ResidualAdapter` -- the bottleneck MLP with a residual blend
  (``ratio * mlp(x) + (1 - ratio) * x``);
- :class:`CachedClipAdapter` -- the training wrapper: adapters applied to
  cached image features and per-class text features, giving CLIP-style
  symmetric contrastive logits scaled by a learnable ``logit_scale``;
- the fabrics the configs name (``LinearClipAdapterFabric``,
  ``OriginalImageClipAdapterFabric``).

Training never touches the CLIP towers. Linear weights are ``nn.Linear``'s
(out, in); the JAX package's Dense kernels are (in, out)
(:func:`state_dict_from_tree` reads its parameter trees). Initial weights are
Flax's ``lecun_normal`` (a normal truncated at two standard deviations of
``fan_in ** -0.5 / 0.8796``), zero biases, drawn from an explicit generator.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["LinearAdapter", "ResidualAdapter", "IdentityAdapter", "CachedClipAdapter",
           "LinearClipAdapterFabric", "OriginalImageClipAdapterFabric", "state_dict_from_tree"]


class IdentityAdapter(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class LinearAdapter(nn.Module):
    def __init__(self, in_dim: int, output_dim: int, use_bias: bool = True):
        super().__init__()
        self.head = nn.Linear(in_dim, output_dim, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(x)


class ResidualAdapter(nn.Module):
    """Bottleneck MLP with residual blend: ratio * mlp(x) + (1 - ratio) * x."""

    def __init__(self, dim: int, reduction: int = 4, ratio: float = 0.2):
        super().__init__()
        self.ratio = ratio
        self.fc1 = nn.Linear(dim, dim // reduction, bias=False)
        self.fc2 = nn.Linear(dim // reduction, dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.fc2(F.relu(self.fc1(x))))
        return self.ratio * h + (1.0 - self.ratio) * x


class CachedClipAdapter(nn.Module):
    """``forward(image_features, text_features)`` -> (logits_i2t, logits_t2i):
    both sides through their adapters, L2-normalized, scaled by
    ``exp(logit_scale)``; row i of the batch pairs with row i of the text."""

    def __init__(self, image_adapter: nn.Module, text_adapter: nn.Module):
        super().__init__()
        self.image_adapter = image_adapter
        self.text_adapter = text_adapter
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07), dtype=torch.float32))

    def init_weights(self, generator: torch.Generator) -> "CachedClipAdapter":
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    std = m.in_features ** -0.5 / 0.87962566103423978
                    w = torch.empty(m.in_features, m.out_features)
                    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
                    m.weight.copy_(w.t())
                    if m.bias is not None:
                        m.bias.zero_()
        return self

    def forward(self, image_features: torch.Tensor, text_features: torch.Tensor
                ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        img = F.normalize(self.image_adapter(image_features), dim=-1)
        txt = F.normalize(self.text_adapter(text_features), dim=-1)
        logits = self.logit_scale.exp() * img @ txt.t()
        return logits, logits.t()

    def encode(self, image_features: torch.Tensor) -> torch.Tensor:
        return self.image_adapter(image_features)


class LinearClipAdapterFabric:
    """Builds a CachedClipAdapter with a linear vision head (+ optional text head)."""

    def __init__(self, output_dim: tp.Optional[int] = None, adapt_text: bool = False):
        self.output_dim = output_dim
        self.adapt_text = adapt_text

    def create_adapter(self, emb_dim: int) -> CachedClipAdapter:
        out = self.output_dim or emb_dim
        # a projecting vision head needs a text head too, or the dims disagree
        needs_text_head = self.adapt_text or out != emb_dim
        return CachedClipAdapter(
            image_adapter=LinearAdapter(emb_dim, out),
            text_adapter=LinearAdapter(emb_dim, out) if needs_text_head else IdentityAdapter())


class OriginalImageClipAdapterFabric:
    """Builds the residual-MLP image adapter (text identity)."""

    def __init__(self, reduction: int = 4, ratio: float = 0.2):
        self.reduction = reduction
        self.ratio = ratio

    def create_adapter(self, emb_dim: int) -> CachedClipAdapter:
        return CachedClipAdapter(image_adapter=ResidualAdapter(emb_dim, self.reduction, self.ratio),
                                 text_adapter=IdentityAdapter())


def state_dict_from_tree(tree: tp.Mapping[str, tp.Any]) -> tp.Dict[str, torch.Tensor]:
    """The JAX package's adapter parameters (a nested tree, Dense kernels
    (in, out)) as a :class:`CachedClipAdapter` state dict: the same module
    names, ``kernel`` as ``weight`` (out, in). A state dict (flat names)
    passes unchanged."""
    if not any(isinstance(v, tp.Mapping) for v in tree.values()):
        return dict(tree)
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, tp.Mapping):
                walk(v, f"{prefix}{k}.")
            elif k == "kernel":
                out[prefix + "weight"] = torch.as_tensor(v).t().contiguous()
            else:
                out[prefix + k] = torch.as_tensor(v)

    walk(tree, "")
    return out
