"""Weights in and out of the port's CLIP modules.

The port's modules use OpenAI's ``clip.load`` key layout, so an OpenAI ``.pt``
(torchscript archive or plain state dict) loads directly (:func:`load_clip`).
:func:`from_flax_variables` is the inverse of the JAX package's
``convert_state_dict`` (``summer_clip_tpu/models/clip/convert.py:130``): it
carries that package's Flax variables (as numpy) across.

- flax ``kernel`` (in, out) -> torch ``Linear.weight`` (out, in)
- separate q/k/v projections -> fused ``attn.in_proj_{weight,bias}``
- flax conv kernel (H, W, I, O) -> torch (O, I, H, W)
- flax ``batch_stats`` mean/var -> BatchNorm ``running_mean`` / ``running_var``
- the attention pool's q/k/v/out projections -> ``attnpool.{q,k,v,c}_proj``
"""

from __future__ import annotations

import typing as tp
from pathlib import Path

import numpy as np
import torch

from summer_clip_torch.core.device import resolve_device
from summer_clip_torch.models.clip.configs import CLIP_CONFIGS

__all__ = ["from_flax_variables", "to_openai_state_dict", "detect_model_name",
           "load_torch_state_dict", "load_clip"]


def detect_model_name(sd: tp.Mapping[str, tp.Any]) -> str:
    """Architecture name from the tensor shapes of an OpenAI-layout state dict."""
    is_vit = "visual.class_embedding" in sd
    embed_dim = tuple(sd["text_projection"].shape)[1]
    if is_vit:
        width, _, _, patch = tuple(sd["visual.conv1.weight"].shape)
        grid = int(round((tuple(sd["visual.positional_embedding"].shape)[0] - 1) ** 0.5))
        layers = len({k.split(".")[3] for k in sd if k.startswith("visual.transformer.resblocks.")})
        for name, c in CLIP_CONFIGS.items():
            if (c.vision_kind == "vit" and c.vision_width == width
                    and c.vision_patch_size == patch and c.image_resolution == grid * patch
                    and c.vision_layers == layers and c.embed_dim == embed_dim):
                return name
    else:
        width = tuple(sd["visual.conv1.weight"].shape)[0] * 2
        counts = tuple(len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{s}.")})
                       for s in (1, 2, 3, 4))
        for name, c in CLIP_CONFIGS.items():
            if (c.vision_kind == "resnet" and c.vision_width == width
                    and tuple(c.vision_layers) == counts and c.embed_dim == embed_dim):
                return name
    raise ValueError("Could not match checkpoint shapes to a known CLIP config")


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _linear(p: tp.Mapping, prefix: str, out: tp.Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _f32(np.asarray(p["kernel"]).T)
    out[f"{prefix}.bias"] = _f32(p["bias"])


def _ln(p: tp.Mapping, prefix: str, out: tp.Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _f32(p["scale"])
    out[f"{prefix}.bias"] = _f32(p["bias"])


def _transformer(p: tp.Mapping, prefix: str, out: tp.Dict[str, torch.Tensor]) -> None:
    n = len([k for k in p if k.startswith("resblocks_")])
    for i in range(n):
        blk = p[f"resblocks_{i}"]
        q = f"{prefix}.resblocks.{i}"
        _ln(blk["ln_1"], f"{q}.ln_1", out)
        _ln(blk["ln_2"], f"{q}.ln_2", out)
        attn = blk["attn"]
        out[f"{q}.attn.in_proj_weight"] = _f32(np.concatenate(
            [np.asarray(attn[k]["kernel"]).T for k in ("q_proj", "k_proj", "v_proj")]))
        out[f"{q}.attn.in_proj_bias"] = _f32(np.concatenate(
            [np.asarray(attn[k]["bias"]) for k in ("q_proj", "k_proj", "v_proj")]))
        _linear(attn["out_proj"], f"{q}.attn.out_proj", out)
        _linear(blk["mlp"]["c_fc"], f"{q}.mlp.c_fc", out)
        _linear(blk["mlp"]["c_proj"], f"{q}.mlp.c_proj", out)


def _conv(p: tp.Mapping, prefix: str, out: tp.Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _f32(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))


def _bn(p: tp.Mapping, stats: tp.Mapping, prefix: str, out: tp.Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _f32(p["scale"])
    out[f"{prefix}.bias"] = _f32(p["bias"])
    out[f"{prefix}.running_mean"] = _f32(stats["mean"])
    out[f"{prefix}.running_var"] = _f32(stats["var"])


def _resnet(v: tp.Mapping, stats: tp.Mapping, out: tp.Dict[str, torch.Tensor]) -> None:
    for i in (1, 2, 3):
        _conv(v[f"conv{i}"], f"visual.conv{i}", out)
        _bn(v[f"bn{i}"], stats[f"bn{i}"], f"visual.bn{i}", out)
    for name in sorted(k for k in v if k.startswith("layer")):
        stage, blk = name[len("layer"):].split("_")
        q = f"visual.layer{stage}.{blk}"
        for i in (1, 2, 3):
            _conv(v[name][f"conv{i}"], f"{q}.conv{i}", out)
            _bn(v[name][f"bn{i}"], stats[name][f"bn{i}"], f"{q}.bn{i}", out)
        if "downsample_conv" in v[name]:
            _conv(v[name]["downsample_conv"], f"{q}.downsample.0", out)
            _bn(v[name]["downsample_bn"], stats[name]["downsample_bn"], f"{q}.downsample.1", out)
    pool = v["attnpool"]
    out["visual.attnpool.positional_embedding"] = _f32(pool["positional_embedding"])
    for src, dst in (("q_proj", "q_proj"), ("k_proj", "k_proj"), ("v_proj", "v_proj"),
                     ("out_proj", "c_proj")):
        _linear(pool["attn"][src], f"visual.attnpool.{dst}", out)


def from_flax_variables(variables: tp.Mapping[str, tp.Any]) -> tp.Dict[str, torch.Tensor]:
    """JAX package variables ``{'params': ..., 'batch_stats': ...}`` (numpy
    leaves; ``batch_stats`` only for ResNet towers) -> OpenAI-layout f32 state
    dict for :class:`~summer_clip_torch.models.clip.modeling.CLIP`. BatchNorm's
    ``num_batches_tracked`` counters are not part of it: load with
    ``strict=False`` or through :func:`load_clip`."""
    params = variables["params"]
    v = params["visual"]
    out: tp.Dict[str, torch.Tensor] = {"logit_scale": _f32(params["logit_scale"])}
    if "class_embedding" in v:
        _conv(v["conv1"], "visual.conv1", out)
        out["visual.class_embedding"] = _f32(v["class_embedding"])
        out["visual.positional_embedding"] = _f32(v["positional_embedding"])
        _ln(v["ln_pre"], "visual.ln_pre", out)
        _ln(v["ln_post"], "visual.ln_post", out)
        out["visual.proj"] = _f32(v["proj"])
        _transformer(v["transformer"], "visual.transformer", out)
    else:
        _resnet(v, variables["batch_stats"]["visual"], out)
    t = params["text"]
    out["token_embedding.weight"] = _f32(t["token_embedding"]["embedding"])
    out["positional_embedding"] = _f32(t["positional_embedding"])
    _ln(t["ln_final"], "ln_final", out)
    out["text_projection"] = _f32(t["text_projection"])
    _transformer(t["transformer"], "transformer", out)
    return out


def to_openai_state_dict(model: torch.nn.Module) -> tp.Dict[str, torch.Tensor]:
    """f32 CPU copy of the model's parameters in OpenAI's key layout."""
    return {k: v.detach().float().cpu().clone() for k, v in model.state_dict().items()}


def load_torch_state_dict(path: tp.Union[str, Path]) -> tp.Dict[str, torch.Tensor]:
    """An OpenAI CLIP checkpoint (torchscript archive or plain state dict), f32."""
    try:
        sd = torch.load(str(path), map_location="cpu", weights_only=False)
    except RuntimeError:  # a torchscript archive, as OpenAI ships them
        sd = torch.jit.load(str(path), map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.float() for k, v in sd.items()
            if k not in ("input_resolution", "context_length", "vocab_size")}


def load_clip(checkpoint_path: tp.Union[str, Path], dtype: torch.dtype = torch.float32,
              device: tp.Union[None, str, torch.device] = None, quant: tp.Optional[str] = None):
    """Checkpoint -> (model, cfg) in the compute ``dtype`` on ``device`` (the
    card when None), its int8 layers set by ``quant``."""
    from summer_clip_torch.models.clip.modeling import CLIP

    device = resolve_device(device)
    sd = load_torch_state_dict(checkpoint_path)
    cfg = CLIP_CONFIGS[detect_model_name(sd)]
    model = CLIP(cfg)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise RuntimeError(f"checkpoint does not match {cfg.name}: missing {missing}, "
                           f"unexpected {list(unexpected)}")
    return model.requires_grad_(False).set_quant(quant).to_compute(dtype).to(device).eval(), cfg
