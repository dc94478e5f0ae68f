"""Random CLIP weights from the seed, in OpenAI's key layout, on the device.

One ``torch.randn`` draw on a generator seeded from ``--seed`` (on the card
when the run has one), cut into the checkpoint's tensors and scaled as
OpenAI's ``CLIP.initialize_parameters`` scales them (attention and MLP
projections by the width, the residual outputs by the depth too), biases and
LayerNorm parameters drawn small around their usual values so that every
bias and scale is exercised. The weights are rounded to bf16, the type the
towers are served in, so the program and the reference hold the same values;
LayerNorm parameters stay float32, as the program keeps them.
"""

from __future__ import annotations

import math
import typing as tp

import torch

from benchmark import seeds


def _vit_keys(c: dict) -> tp.List[tp.Tuple[str, tp.Tuple[int, ...], str, float]]:
    w, layers, p = c["vision_width"], c["vision_layers"], c["vision_patch_size"]
    grid = c["image_resolution"] // p
    keys = [("visual.conv1.weight", (w, 3, p, p), "w", (3 * p * p) ** -0.5),
            ("visual.class_embedding", (w,), "w", w ** -0.5),
            ("visual.positional_embedding", (grid * grid + 1, w), "w", w ** -0.5),
            ("visual.ln_pre.weight", (w,), "ln_w", 0.0), ("visual.ln_pre.bias", (w,), "ln_b", 0.0)]
    keys += _blocks("visual.transformer.resblocks", w, layers, c["mlp_ratio"])
    keys += [("visual.ln_post.weight", (w,), "ln_w", 0.0), ("visual.ln_post.bias", (w,), "ln_b", 0.0),
             ("visual.proj", (w, c["embed_dim"]), "w", w ** -0.5)]
    return keys


def _text_keys(c: dict) -> tp.List[tp.Tuple[str, tp.Tuple[int, ...], str, float]]:
    w = c["text_width"]
    keys = [("token_embedding.weight", (c["vocab_size"], w), "w", 0.02),
            ("positional_embedding", (c["context_length"], w), "w", 0.01)]
    keys += _blocks("transformer.resblocks", w, c["text_layers"], c["mlp_ratio"])
    keys += [("ln_final.weight", (w,), "ln_w", 0.0), ("ln_final.bias", (w,), "ln_b", 0.0),
             ("text_projection", (w, c["embed_dim"]), "w", w ** -0.5)]
    return keys


def _blocks(prefix: str, w: int, layers: int, ratio: int):
    attn_std, proj_std, fc_std = w ** -0.5, w ** -0.5 * (2 * layers) ** -0.5, (2 * w) ** -0.5
    out = []
    for i in range(layers):
        q = f"{prefix}.{i}"
        out += [(f"{q}.ln_1.weight", (w,), "ln_w", 0.0), (f"{q}.ln_1.bias", (w,), "ln_b", 0.0),
                (f"{q}.attn.in_proj_weight", (3 * w, w), "w", attn_std),
                (f"{q}.attn.in_proj_bias", (3 * w,), "b", 0.0),
                (f"{q}.attn.out_proj.weight", (w, w), "w", proj_std),
                (f"{q}.attn.out_proj.bias", (w,), "b", 0.0),
                (f"{q}.ln_2.weight", (w,), "ln_w", 0.0), (f"{q}.ln_2.bias", (w,), "ln_b", 0.0),
                (f"{q}.mlp.c_fc.weight", (ratio * w, w), "w", fc_std),
                (f"{q}.mlp.c_fc.bias", (ratio * w,), "b", 0.0),
                (f"{q}.mlp.c_proj.weight", (w, ratio * w), "w", proj_std),
                (f"{q}.mlp.c_proj.bias", (w,), "b", 0.0)]
    return out


def _keys(config: dict, towers: tp.Sequence[str]):
    return ((_vit_keys(config) if "image" in towers else [])
            + (_text_keys(config) if "text" in towers else []))


def zeros(config: dict, towers: tp.Sequence[str],
          device: tp.Union[str, torch.device]) -> tp.Dict[str, torch.Tensor]:
    """Zero tensors in the named towers' places (a tower the cell never runs),
    each a zero-stride view of one element."""
    return {name: torch.zeros((), device=device,
                              dtype=torch.float32 if kind.startswith("ln") else torch.bfloat16
                              ).expand(shape)
            for name, shape, kind, _ in _keys(config, towers)}


def clip_state_dict(config: dict, seed: int, device: tp.Union[str, torch.device],
                    towers: tp.Sequence[str] = ("image", "text")) -> tp.Dict[str, torch.Tensor]:
    """The configuration's CLIP (both towers, or the ones named) from ``seed``:
    bf16 weights, float32 LayerNorm parameters and ``logit_scale``."""
    keys = _keys(config, towers)
    total = sum(math.prod(shape) for _, shape, _, _ in keys)
    gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, "weights", *towers))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    sd: tp.Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, kind, std in keys:
        n = math.prod(shape)
        z = flat[at:at + n].view(shape)
        at += n
        if kind == "w":
            sd[name] = (z * std).to(torch.bfloat16)
        elif kind == "b":
            sd[name] = (z * 0.02).to(torch.bfloat16)
        elif kind == "ln_w":
            sd[name] = 1.0 + 0.1 * z
        else:
            sd[name] = 0.02 * z
    sd["logit_scale"] = torch.tensor(math.log(1.0 / 0.07), device=device)
    del flat
    return sd


def write_checkpoint(config: dict, seed: int, device: tp.Union[str, torch.device], path,
                     towers: tp.Sequence[str] = ("image", "text")):
    """An OpenAI-layout checkpoint at ``path`` for the port's own loading path
    (``create_clip_session(checkpoint_path=...)``): the named towers from
    ``seed``, every other tower as one-element zero views. Returns ``path``."""
    sd = clip_state_dict(config, seed, device, towers=towers)
    sd.update(zeros(config, [t for t in ("image", "text") if t not in towers], "cpu"))
    torch.save({k: v.cpu() for k, v in sd.items()}, path)
    return path
