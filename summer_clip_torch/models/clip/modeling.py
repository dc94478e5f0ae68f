"""CLIP towers as PyTorch modules: ViT image tower, text tower, CLIP head.

Counterpart of ``summer_clip_tpu/models/clip/modeling.py`` (ViT, ModifiedResNet
and text towers). Parameters use OpenAI's
``clip.load`` key layout (``visual.conv1.weight``,
``transformer.resblocks.0.attn.in_proj_weight``, ...), so an OpenAI state dict
loads directly; :mod:`summer_clip_torch.models.clip.convert` carries the JAX
package's Flax variables across.

Conventions kept from the JAX package:

- images are NHWC at :meth:`CLIP.encode_image`;
- LayerNorm runs in f32 with f32 parameters whatever the compute dtype
  (:meth:`CLIP.to_compute` casts every other parameter);
- the text tower pools at the argmax token id for token inputs and at
  ``len - 1`` for embeddings (:meth:`TextTransformer.from_embeds`).

Each half of a residual block picks its route by :func:`attn_route` and
:func:`mlp_route`: the JAX package's ``_fuse_attn_ok`` / ``_fuse_mlp_ok`` and
``_mlp_dispatch`` under :data:`FUSED_BLOCK_MODE` (its modes and its default,
``"block"``), at the kernels' bf16 item size, and what the kernels take
(:func:`~summer_clip_torch.ops.block_kernels.fused_attn_ok` and its MLP
siblings; the two agree for every public geometry). In ``"block"`` mode
ViT-B/32, ViT-B/16 and every text tower run K5
(:func:`~summer_clip_torch.ops.block_kernels.fused_ln_attn_ad`) and K6; the
ViT-L/14 and ViT-L/14@336px image towers (T = 257 / 577, D = 1024) run
``LayerNormF32 -> in_proj -> multi_head_attention (K4) -> out_proj`` and
``LayerNormF32 -> c_fc -> QuickGELU -> c_proj`` with ``torch.matmul``, the
products the JAX package leaves to XLA there. In ``"mlp"`` mode the ViT-L/14
image tower's MLP half takes K9 (:func:`~summer_clip_torch.ops.block_kernels.
fused_ln_mlp_ad` dispatches it by weight size) and every other tower the
plain MLP; ``"attn"`` and ``"xla"`` fuse no half. Every kernel is reached
through its ``_ad`` wrapper, so a gradient flows through any route. A kernel
that refuses its input raises; no route is chosen by catching that.
``remat=True`` runs each residual block under ``torch.utils.checkpoint``, the
JAX package's ``nn.remat``. The ModifiedResNet tower uses stock
``torch.nn.Conv2d`` and runs none of the hand-written kernels, as it runs no
Pallas kernel in the JAX package.

``quant="int8"`` (:meth:`CLIP.set_quant`, ``build_clip(..., quant=)``, config
``clip.quant``) is the JAX package's opt-in int8 inference
(:mod:`summer_clip_torch.ops.int8`): every residual block's q/k/v, out_proj,
c_fc and c_proj products, the ResNet convolutions and the attention pool's
projections run int8 x int8 -> int32 with scales taken from f32 weights (those
layers keep f32 parameters in every compute dtype). A quantized block always
takes the module route, never K5, K6 or K9: its attention core is
:func:`multi_head_attention`, so K4 on the card. The patch embedding and the
final projections stay in the compute dtype, as in the JAX package. The port
keeps q, k and v stacked in ``in_proj_weight``; quantizing the stack column by
column with the rows' shared activation scale is the JAX package's three
separate ``QuantDense``s.

Spans (:mod:`summer_clip_torch.core.profiling`, recorded only while it is on):
``tower.image`` and ``tower.text`` around each tower, and around each half of
every residual block, whatever its route, ``block.attn`` and ``block.mlp``,
timed on the card by CUDA events; the counter ``tower.blocks`` adds the blocks
a tower runs.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from summer_clip_torch.core import profiling
from summer_clip_torch.core.device import resolve_device
from summer_clip_torch.models.clip.configs import CLIP_CONFIGS, CLIPConfig
from summer_clip_torch.ops import block_kernels as bk
from summer_clip_torch.ops import int8
from summer_clip_torch.ops.attention import SHORT_MAX_T, mha_reference, multi_head_attention

__all__ = ["LayerNormF32", "Attention", "MLP", "ResidualAttentionBlock", "Transformer",
           "PatchEmbed", "VisionTransformer", "Bottleneck", "AttentionPool2d",
           "ModifiedResNet", "TextTransformer", "CLIP", "build_clip", "attn_route",
           "mlp_route", "FUSED_BLOCK_MODE"]

# Which halves of a residual block take a fused kernel: the JAX package's
# policy and default. "block": both halves where the gates allow; "attn": no
# fused half (the attention core still auto-selects K4); "mlp": only the MLP
# half through the hidden-chunked kernel K9 (the ViT-L/14 image tower) beside
# the K4 attention route; "xla": no fused half.
FUSED_BLOCK_MODE = "block"
_ITEMSIZE = 2   # the kernels' bf16: the gates are worked out at their item size


def _fuse_base_ok(d: int, t: int, num_heads: int, modes: tp.Tuple[str, ...] = ("block",)) -> bool:
    return FUSED_BLOCK_MODE in modes and d % num_heads == 0 and t <= SHORT_MAX_T


def attn_route(d: int, t: int, num_heads: int) -> str:
    """``"k5"`` (the fused attention half) or ``"module"`` (LayerNorm ->
    in_proj -> :func:`multi_head_attention` -> out_proj): the JAX package's
    ``_fuse_attn_ok`` (weights and one sequence's activations within its 12 MB
    budget), and what K5 takes."""
    total = (4 * d * d + 9 * t * d) * _ITEMSIZE + 4 * t * t
    ok = _fuse_base_ok(d, t, num_heads) and total <= 12 * 1024 * 1024
    return "k5" if ok and bk.fused_attn_ok(t, d, num_heads) else "module"


def mlp_route(d: int, t: int, num_heads: int, hidden: int) -> str:
    """``"k6"``, ``"k9"`` or ``"plain"``: the JAX package's ``_fuse_mlp_ok``
    (the resident-weight kernel in "block" mode where the weights and one
    sequence fit 14 MB; the hidden-chunked kernel in "mlp" mode where a
    streamed weight-chunk pair and the activations do), then its
    ``_mlp_dispatch`` (K9 above ``FUSED_MLP_MAX_WEIGHT_BYTES`` of weights,
    else K6), and what that kernel takes."""
    if (8 * d * d + 8 * t * d) * _ITEMSIZE <= 14 * 1024 * 1024:
        ok = _fuse_base_ok(d, t, num_heads)
    else:
        chunked = 8 * 1024 * 1024 + 5 * t * d * _ITEMSIZE + 4 * t * d
        ok = _fuse_base_ok(d, t, num_heads, modes=("mlp",)) and chunked <= 14 * 1024 * 1024
    if not ok:
        return "plain"
    if 2 * d * hidden * _ITEMSIZE > bk.FUSED_MLP_MAX_WEIGHT_BYTES:
        return "k9" if bk.fused_mlp_chunked_ok(d, hidden) else "plain"
    return "k6" if bk.fused_mlp_ok(d, hidden) else "plain"


class LayerNormF32(nn.Module):
    """LayerNorm computed in float32 regardless of the activation dtype."""

    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bk.ln_f32(x, self.weight, self.bias, self.eps)


class Attention(nn.Module):
    """Multi-head self-attention parameters in ``nn.MultiheadAttention``'s
    layout: q/k/v stacked in ``in_proj_weight`` (3D, D), then ``out_proj``."""

    def __init__(self, d: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)


class MLP(nn.Module):
    """c_fc -> QuickGELU -> c_proj (4x width); parameters only, the block's
    fused kernel computes it."""

    def __init__(self, d: int, ratio: int = 4):
        super().__init__()
        self.c_fc = nn.Linear(d, d * ratio)
        self.c_proj = nn.Linear(d * ratio, d)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, d: int, num_heads: int):
        super().__init__()
        self.attn = Attention(d, num_heads)
        self.ln_1 = LayerNormF32(d)
        self.mlp = MLP(d)
        self.ln_2 = LayerNormF32(d)
        self.quant: tp.Optional[str] = None

    def quant_params(self) -> tp.List[nn.Parameter]:
        """The parameters the int8 products read (kept f32 under ``quant``)."""
        a, m = self.attn, self.mlp
        return [a.in_proj_weight, a.in_proj_bias, *a.out_proj.parameters(),
                *m.c_fc.parameters(), *m.c_proj.parameters()]

    def _attn_half(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        """``x + out_proj(MHA(LN(x)))``: K5, the module route (K4 between two
        products) or, under ``quant``, the JAX package's quantized module path
        (int8 q/k/v in one product of the stacked weight, int8 out_proj)."""
        a = self.attn
        t, d = x.shape[-2], x.shape[-1]
        if self.quant == "int8":
            q, k, v = int8.int8_linear(self.ln_1(x), a.in_proj_weight,
                                       a.in_proj_bias).split(d, dim=-1)
            o = multi_head_attention(q, k, v, num_heads=a.num_heads, causal=causal)
            return x + int8.int8_linear(o, a.out_proj.weight, a.out_proj.bias)
        if attn_route(d, t, a.num_heads) == "k5":
            return bk.fused_ln_attn_ad(x, self.ln_1.weight, self.ln_1.bias, a.in_proj_weight,
                                       a.in_proj_bias, a.out_proj.weight, a.out_proj.bias,
                                       num_heads=a.num_heads, causal=causal, eps=self.ln_1.eps)
        # q, k, v stay views of the fused projection: K4 reads them in place
        q, k, v = bk.dense(self.ln_1(x), a.in_proj_weight, a.in_proj_bias).split(d, dim=-1)
        o = multi_head_attention(q, k, v, num_heads=a.num_heads, causal=causal)
        return x + bk.dense(o, a.out_proj.weight, a.out_proj.bias)

    def _mlp_half(self, x: torch.Tensor) -> torch.Tensor:
        """``x + c_proj(QuickGELU(c_fc(LN(x))))``: K6 or K9, the plain
        products, or int8 c_fc and c_proj under ``quant``."""
        a, m = self.attn, self.mlp
        if self.quant == "int8":
            h = bk.quick_gelu(int8.int8_linear(self.ln_2(x), m.c_fc.weight, m.c_fc.bias))
            return x + int8.int8_linear(h, m.c_proj.weight, m.c_proj.bias)
        t, d = x.shape[-2], x.shape[-1]
        if mlp_route(d, t, a.num_heads, m.c_fc.out_features) != "plain":
            # K6 or K9, by the weight size (bk.mlp_kernel)
            return bk.fused_ln_mlp_ad(x, self.ln_2.weight, self.ln_2.bias, m.c_fc.weight,
                                      m.c_fc.bias, m.c_proj.weight, m.c_proj.bias,
                                      eps=self.ln_2.eps)
        h = bk.quick_gelu(bk.dense(self.ln_2(x), m.c_fc.weight, m.c_fc.bias))
        return x + bk.dense(h, m.c_proj.weight, m.c_proj.bias)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        """Both halves, each in a device span (``core/profiling``); results
        in x's dtype."""
        with profiling.span("block.attn", device=x):
            x = self._attn_half(x, causal)
        with profiling.span("block.mlp", device=x):
            return self._mlp_half(x)


class Transformer(nn.Module):
    def __init__(self, width: int, num_layers: int, num_heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, num_heads) for _ in range(num_layers))
        self.remat = False   # recompute each block's activations in the backward

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        profiling.count("tower.blocks", len(self.resblocks))
        for block in self.resblocks:
            if self.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(block, x, causal, use_reentrant=False)
            else:
                x = block(x, causal)
        return x


class PatchEmbed(nn.Module):
    """Non-overlapping patch embedding as a strided conv (OpenAI's ``conv1``,
    weight (width, 3, p, p), no bias). NHWC in, (B, patches, width) out."""

    def __init__(self, width: int, patch_size: int):
        super().__init__()
        self.patch_size = patch_size
        self.weight = nn.Parameter(torch.empty(width, 3, patch_size, patch_size))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(self.weight.dtype).permute(0, 3, 1, 2)
        out = F.conv2d(x, self.weight, stride=self.patch_size)   # (B, W, g, g)
        return out.flatten(2).transpose(1, 2)


class VisionTransformer(nn.Module):
    """CLIP ViT image tower. Input (B, H, W, 3) -> (B, output_dim)."""

    def __init__(self, image_resolution: int, patch_size: int, width: int,
                 num_layers: int, num_heads: int, output_dim: int):
        super().__init__()
        grid = image_resolution // patch_size
        self.conv1 = PatchEmbed(width, patch_size)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, width))
        self.ln_pre = LayerNormF32(width)
        self.transformer = Transformer(width, num_layers, num_heads)
        self.ln_post = LayerNormF32(width)
        self.proj = nn.Parameter(torch.empty(width, output_dim))

    def forward(self, images: torch.Tensor, apply_proj: bool = True) -> torch.Tensor:
        x = self.conv1(images)
        dtype = x.dtype
        cls = self.class_embedding.to(dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dtype)
        x = self.ln_pre(x)
        x = self.transformer(x)
        x = self.ln_post(x[:, 0])
        if not apply_proj:
            return x
        return x @ self.proj.to(dtype)


def _conv_of(quant: tp.Optional[str]) -> tp.Callable[[nn.Conv2d, torch.Tensor], torch.Tensor]:
    """``conv(module, x)``: the module itself, or its int8 counterpart."""
    if quant == "int8":
        return lambda c, x: int8.int8_conv2d(x, c.weight, c.stride[0], c.padding[0])
    return lambda c, x: c(x)


class Bottleneck(nn.Module):
    """ResNet bottleneck with CLIP's anti-aliased downsampling: every stride-2
    convolution is a stride-1 convolution followed by a 2x2 average pool.
    Module names follow OpenAI's (``downsample`` holds the pool as ``-1``, the
    convolution as ``0`` and its BatchNorm as ``1``). NCHW inside the tower."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.avgpool = nn.AvgPool2d(stride) if stride > 1 else nn.Identity()
        self.conv3 = nn.Conv2d(planes, out_ch, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out_ch)
        self.downsample = None
        if stride > 1 or inplanes != out_ch:
            self.downsample = nn.Sequential()
            self.downsample.add_module("-1", nn.AvgPool2d(stride) if stride > 1 else nn.Identity())
            self.downsample.add_module("0", nn.Conv2d(inplanes, out_ch, 1, bias=False))
            self.downsample.add_module("1", nn.BatchNorm2d(out_ch))

        self.quant: tp.Optional[str] = None

    def quant_params(self) -> tp.List[nn.Parameter]:
        convs = [self.conv1, self.conv2, self.conv3]
        if self.downsample is not None:
            convs.append(self.downsample[1])   # (pool, conv, bn)
        return [c.weight for c in convs]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = _conv_of(self.quant)
        y = F.relu(self.bn1(conv(self.conv1, x)))
        y = F.relu(self.bn2(conv(self.conv2, y)))
        y = self.bn3(conv(self.conv3, self.avgpool(y)))
        identity = x
        if self.downsample is not None:
            pool, down, bn = self.downsample
            identity = bn(conv(down, pool(x)))
        return F.relu(y + identity)


class AttentionPool2d(nn.Module):
    """Attention pooling head: the mean token queries the feature map. One
    query against H*W + 1 keys, so it runs the plain attention (as it runs
    XLA's in the JAX package), not the short-attention kernel. Under
    ``quant="int8"`` the four projections are int8 products."""

    def __init__(self, tokens: int, embed_dim: int, num_heads: int, output_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.quant: tp.Optional[str] = None
        self.positional_embedding = nn.Parameter(torch.empty(tokens + 1, embed_dim))
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[1]
        x = x.flatten(2).transpose(1, 2)                         # (B, HW, C)
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)   # (B, HW+1, C)
        x = x + self.positional_embedding.to(x.dtype)

        def split(z):
            return z.reshape(b, z.shape[1], self.num_heads, c // self.num_heads).transpose(1, 2)

        if self.quant == "int8":
            def proj(lin, z):
                return int8.int8_linear(z, lin.weight, lin.bias)
        else:
            def proj(lin, z):
                return lin(z)
        o = mha_reference(split(proj(self.q_proj, x[:, :1])), split(proj(self.k_proj, x)),
                          split(proj(self.v_proj, x)))
        return proj(self.c_proj, o.transpose(1, 2).reshape(b, 1, c))[:, 0]

    def quant_params(self) -> tp.List[nn.Parameter]:
        return [p for lin in (self.q_proj, self.k_proj, self.v_proj, self.c_proj)
                for p in lin.parameters()]


class ModifiedResNet(nn.Module):
    """CLIP's ResNet: 3-conv stem, blur-pool bottlenecks, attention pool.
    Input (B, H, W, 3) -> (B, output_dim). BatchNorm uses its running
    statistics (the model is frozen)."""

    def __init__(self, layers: tp.Sequence[int], output_dim: int, num_heads: int,
                 image_resolution: int, width: int):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width // 2, 3, stride=2, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(width // 2)
        self.conv2 = nn.Conv2d(width // 2, width // 2, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(width // 2)
        self.conv3 = nn.Conv2d(width // 2, width, 3, padding=1, bias=False)
        self.bn3 = nn.BatchNorm2d(width)
        self.avgpool = nn.AvgPool2d(2)
        inplanes = width
        for stage, (blocks, stride) in enumerate(zip(layers, (1, 2, 2, 2)), start=1):
            planes = width * 2 ** (stage - 1)
            stack = [Bottleneck(inplanes, planes, stride)]
            inplanes = planes * Bottleneck.expansion
            stack += [Bottleneck(inplanes, planes) for _ in range(1, blocks)]
            setattr(self, f"layer{stage}", nn.Sequential(*stack))
        self.attnpool = AttentionPool2d((image_resolution // 32) ** 2, width * 32, num_heads,
                                        output_dim)
        self.quant: tp.Optional[str] = None

    def quant_params(self) -> tp.List[nn.Parameter]:
        return [self.conv1.weight, self.conv2.weight, self.conv3.weight]

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        # the compute dtype: the pool's embedding is cast to it whatever quant says
        x = images.to(self.attnpool.positional_embedding.dtype).permute(0, 3, 1, 2)
        conv = _conv_of(self.quant)
        x = F.relu(self.bn1(conv(self.conv1, x)))
        x = F.relu(self.bn2(conv(self.conv2, x)))
        x = F.relu(self.bn3(conv(self.conv3, x)))
        x = self.avgpool(x)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.attnpool(x)


def _norm_param_ids(model: nn.Module) -> tp.Set[int]:
    """Parameters of LayerNorm and BatchNorm modules: they keep their unit
    and zero initial values and stay f32 in every compute dtype."""
    return {id(p) for m in model.modules() if isinstance(m, (LayerNormF32, nn.BatchNorm2d))
            for p in m.parameters()}


class TextTransformer(nn.Module):
    """CLIP text tower with two entries: token ids (pool at the argmax id, the
    <eot> token) or spliced embeddings + lengths (pool at ``len - 1``)."""

    def __init__(self, vocab_size: int, context_length: int, width: int,
                 num_layers: int, num_heads: int, output_dim: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.transformer = Transformer(width, num_layers, num_heads)
        self.ln_final = LayerNormF32(width)
        self.text_projection = nn.Parameter(torch.empty(width, output_dim))

    def embed(self, token_ids: torch.Tensor) -> torch.Tensor:
        return self.token_embedding(token_ids)

    def _encode(self, x: torch.Tensor, eot_idx: torch.Tensor) -> torch.Tensor:
        with profiling.span("tower.text"):
            t = x.shape[1]
            x = x + self.positional_embedding[:t].to(x.dtype)
            x = self.transformer(x, causal=True)
            x = self.ln_final(x)
            pooled = x[torch.arange(x.shape[0], device=x.device), eot_idx]
            return pooled @ self.text_projection.to(x.dtype)

    def encode_text(self, token_ids: torch.Tensor) -> torch.Tensor:
        return self._encode(self.embed(token_ids), token_ids.argmax(dim=-1))

    def from_embeds(self, inputs_embeds: torch.Tensor, input_lens: torch.Tensor) -> torch.Tensor:
        dtype = self.token_embedding.weight.dtype
        return self._encode(inputs_embeds.to(dtype), input_lens.long() - 1)


class CLIP(TextTransformer):
    """Joint image/text model. The text tower's parameters sit at the top
    level, as in OpenAI's checkpoints; ``visual`` holds the image tower."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__(cfg.vocab_size, cfg.context_length, cfg.text_width,
                         cfg.text_layers, cfg.text_heads, cfg.embed_dim)
        self.cfg = cfg
        if cfg.vision_kind == "vit":
            self.visual: nn.Module = VisionTransformer(
                cfg.image_resolution, int(cfg.vision_patch_size), cfg.vision_width,
                int(cfg.vision_layers), cfg.vision_heads, cfg.embed_dim)
        else:
            self.visual = ModifiedResNet(tuple(cfg.vision_layers), cfg.embed_dim,
                                         cfg.vision_heads, cfg.image_resolution,
                                         cfg.vision_width)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))

    def init_weights(self, generator: torch.Generator) -> "CLIP":
        """Random weights drawn from ``generator`` (the JAX package's init
        scales: normal embeddings, fan-in-scaled projections, zero biases)."""
        def normal_(p: torch.Tensor, std: float) -> None:
            with torch.no_grad():
                p.copy_(torch.randn(p.shape, generator=generator) * std)

        ln_params = _norm_param_ids(self)
        for name, p in self.named_parameters():
            if p.dim() == 0 or id(p) in ln_params:
                continue                                 # log(1/0.07); LN ones and zeros
            if name.endswith("bias"):
                with torch.no_grad():
                    p.zero_()
            elif name == "token_embedding.weight":
                normal_(p, 0.02)
            elif name == "positional_embedding":
                normal_(p, 0.01)
            elif p.dim() == 4:                           # patch conv, ResNet convs
                normal_(p, p[0].numel() ** -0.5)
            elif name.endswith("weight"):                # Linear / in_proj (out, in)
                normal_(p, p.shape[1] ** -0.5)
            else:                                        # class/pos embedding, projections
                width = self.cfg.vision_width if name.startswith("visual.") else self.cfg.text_width
                normal_(p, width ** -0.5)
        return self

    def set_quant(self, quant: tp.Optional[str]) -> "CLIP":
        """``None`` or ``"int8"`` for every quantizable layer of both towers
        (the module docstring); call before :meth:`to_compute`."""
        quant = int8.check_quant(quant)
        for m in self.modules():
            if hasattr(m, "quant_params"):
                m.quant = quant
        return self

    def to_compute(self, dtype: torch.dtype) -> "CLIP":
        """Cast every parameter to ``dtype`` except the LayerNorm and
        BatchNorm parameters, ``logit_scale`` and the weights of int8 layers,
        which stay f32 (the JAX package's policy)."""
        keep = _norm_param_ids(self)
        keep.add(id(self.logit_scale))
        keep.update(id(p) for m in self.modules() if getattr(m, "quant", None)
                    for p in m.quant_params())
        with torch.no_grad():
            for p in self.parameters():
                if id(p) not in keep:
                    p.data = p.data.to(dtype)
        return self

    def set_remat(self, remat: bool) -> "CLIP":
        """Run every residual block of both towers under activation
        checkpointing (config ``clip.remat``)."""
        for m in self.modules():
            if isinstance(m, Transformer):
                m.remat = bool(remat)
        return self

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        with profiling.span("tower.image"):
            return self.visual(images)

    def encode_image_preproj(self, images: torch.Tensor) -> torch.Tensor:
        with profiling.span("tower.image"):
            return self.visual(images, apply_proj=False)

    def encode_text_embeds(self, inputs_embeds: torch.Tensor,
                           input_lens: torch.Tensor) -> torch.Tensor:
        return self.from_embeds(inputs_embeds, input_lens)

    def forward(self, images: torch.Tensor, token_ids: torch.Tensor
                ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        img = self.encode_image(images).float()
        txt = self.encode_text(token_ids).float()
        img = img / img.norm(dim=-1, keepdim=True)
        txt = txt / txt.norm(dim=-1, keepdim=True)
        logits_per_image = self.logit_scale.exp() * img @ txt.t()
        return logits_per_image, logits_per_image.t()


def build_clip(name: str, generator: tp.Optional[torch.Generator] = None,
               dtype: torch.dtype = torch.float32,
               device: tp.Union[None, str, torch.device] = None,
               quant: tp.Optional[str] = None) -> tp.Tuple[CLIP, CLIPConfig]:
    """Build the named model, frozen, with random weights from ``generator``
    (seed 0 when None), its int8 layers set by ``quant`` (the same weights
    either way), cast to the compute ``dtype`` and moved to ``device`` (the
    card when None)."""
    device = resolve_device(device)
    cfg = CLIP_CONFIGS[name]
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = CLIP(cfg).init_weights(generator).requires_grad_(False).set_quant(quant)
    return model.to_compute(dtype).to(device).eval(), cfg
