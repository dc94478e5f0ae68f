"""CLIP model registry: the architectures ``clip.load()`` exposes.

The same table as ``summer_clip_tpu/models/clip/configs.py`` (re-declared here
because that module builds Flax modules on import). A test holds the two tables
field by field.
"""

from __future__ import annotations

import dataclasses
import typing as tp

__all__ = ["CLIPConfig", "CLIP_CONFIGS", "available_models"]


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    name: str
    embed_dim: int
    image_resolution: int
    # vision: either resnet (layers tuple) or vit (patch size)
    vision_kind: str  # 'resnet' | 'vit'
    vision_width: int
    vision_layers: tp.Union[tp.Tuple[int, int, int, int], int]
    vision_patch_size: tp.Optional[int]
    # text
    context_length: int
    vocab_size: int
    text_width: int
    text_heads: int
    text_layers: int

    @property
    def vision_heads(self) -> int:
        if self.vision_kind == "resnet":
            return (self.vision_width * 32) // 64  # attnpool head_dim 64
        return self.vision_width // 64


def _rn(name, embed, res, layers, width, tw, th):
    return CLIPConfig(name, embed, res, "resnet", width, layers, None, 77, 49408, tw, th, 12)


def _vit(name, embed, res, patch, width, layers, tw, th, tl=12):
    return CLIPConfig(name, embed, res, "vit", width, layers, patch, 77, 49408, tw, th, tl)


CLIP_CONFIGS: tp.Dict[str, CLIPConfig] = {c.name: c for c in [
    _rn("RN50", 1024, 224, (3, 4, 6, 3), 64, 512, 8),
    _rn("RN101", 512, 224, (3, 4, 23, 3), 64, 512, 8),
    _rn("RN50x4", 640, 288, (4, 6, 10, 6), 80, 640, 10),
    _rn("RN50x16", 768, 384, (6, 8, 18, 8), 96, 768, 12),
    _rn("RN50x64", 1024, 448, (3, 15, 36, 10), 128, 1024, 16),
    _vit("ViT-B/32", 512, 224, 32, 768, 12, 512, 8),
    _vit("ViT-B/16", 512, 224, 16, 768, 12, 512, 8),
    _vit("ViT-L/14", 768, 224, 14, 1024, 24, 768, 12),
    _vit("ViT-L/14@336px", 768, 336, 14, 1024, 24, 768, 12),
    # tiny configs for CPU tests / CI (not part of the public family)
    _vit("test-vit", 32, 32, 8, 64, 2, 32, 2, 2),
    CLIPConfig("test-rn", 32, 64, "resnet", 8, (1, 1, 1, 1), None, 16, 512, 32, 2, 2),
]}


def available_models() -> tp.List[str]:
    return [n for n in CLIP_CONFIGS if not n.startswith("test-")]
