"""Plain CLIP towers in float32, written from the published architecture.

OpenAI's ``clip/model.py`` (VisionTransformer, Transformer,
ResidualAttentionBlock, CLIP.encode_text) over an OpenAI-layout state dict:
pre-LayerNorm residual blocks, multi-head attention with q, k and v stacked in
``in_proj_weight``, a QuickGELU MLP of four times the width, the class token
and ``ln_post`` then ``proj`` for images, a causal mask and pooling at the
end-of-text token (the largest id) then ``text_projection`` for text. Images
arrive as uint8 NHWC and are normalized with CLIP's mean and deviation.

``dtype`` is the precision of the activations and products: float32 with
TF32 off, or bf16, the precision the configurations state for the towers,
where every product accumulates in float32 and rounds its output to bf16, the
attention scores are float32 products of the bf16 q and k, and LayerNorm and
softmax run in float32 and round to bf16.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _ln(x: torch.Tensor, sd: tp.Mapping[str, torch.Tensor], key: str) -> torch.Tensor:
    w, b = sd[f"{key}.weight"].float(), sd[f"{key}.bias"].float()
    return F.layer_norm(x.float(), x.shape[-1:], w, b, 1e-5).to(x.dtype)


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype).t() + b.to(x.dtype)


def _block(x: torch.Tensor, sd, key: str, heads: int, causal: bool) -> torch.Tensor:
    b, t, d = x.shape
    hd = d // heads
    y = _ln(x, sd, f"{key}.ln_1")
    qkv = _linear(y, sd[f"{key}.attn.in_proj_weight"], sd[f"{key}.attn.in_proj_bias"])
    q, k, v = (z.reshape(b, t, heads, hd).transpose(1, 2) for z in qkv.split(d, dim=-1))
    s = (q.float() @ k.float().transpose(-1, -2)) * hd ** -0.5
    if causal:
        s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool, device=x.device).tril(),
                          float("-inf"))
    o = (torch.softmax(s, dim=-1).to(x.dtype) @ v).transpose(1, 2).reshape(b, t, d)
    x = x + _linear(o, sd[f"{key}.attn.out_proj.weight"], sd[f"{key}.attn.out_proj.bias"])
    h = _linear(_ln(x, sd, f"{key}.ln_2"), sd[f"{key}.mlp.c_fc.weight"], sd[f"{key}.mlp.c_fc.bias"])
    h = h * torch.sigmoid(1.702 * h)
    return x + _linear(h, sd[f"{key}.mlp.c_proj.weight"], sd[f"{key}.mlp.c_proj.bias"])


def _layers(sd, prefix: str) -> int:
    return len({k.split(".")[len(prefix.split("."))] for k in sd
                if k.startswith(prefix + ".")})


def encode_image(sd: tp.Mapping[str, torch.Tensor], images_u8: torch.Tensor, *, patch: int,
                 heads: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, embed) image features (before normalization)."""
    mean = torch.tensor(CLIP_MEAN, device=images_u8.device)
    std = torch.tensor(CLIP_STD, device=images_u8.device)
    x = ((images_u8.float() / 255.0 - mean) / std).permute(0, 3, 1, 2).to(dtype)
    x = F.conv2d(x, sd["visual.conv1.weight"].to(dtype), stride=patch)
    x = x.flatten(2).transpose(1, 2)
    cls = sd["visual.class_embedding"].to(dtype).expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + sd["visual.positional_embedding"].to(dtype)
    x = _ln(x, sd, "visual.ln_pre")
    for i in range(_layers(sd, "visual.transformer.resblocks")):
        x = _block(x, sd, f"visual.transformer.resblocks.{i}", heads, causal=False)
    x = _ln(x[:, 0], sd, "visual.ln_post")
    return (x @ sd["visual.proj"].to(dtype)).float()


def encode_text(sd: tp.Mapping[str, torch.Tensor], tokens: torch.Tensor, *, heads: int,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, 77) token ids -> (B, embed) text features, pooled at the
    end-of-text token (the row's largest id)."""
    x = sd["token_embedding.weight"].to(dtype)[tokens]
    x = x + sd["positional_embedding"].to(dtype)[:tokens.shape[1]]
    for i in range(_layers(sd, "transformer.resblocks")):
        x = _block(x, sd, f"transformer.resblocks.{i}", heads, causal=True)
    x = _ln(x, sd, "ln_final")
    x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
    return (x @ sd["text_projection"].to(dtype)).float()
