"""GPT head variants for the autoregressive prompt proposer (Gumbelv3a1).

Counterpart of ``summer_clip_tpu/methods/gpt_heads.py``:

- :class:`EmbsAdapter` -- residual ReLU MLP on the last hidden state with the
  RL-Prompt near-zero init (xavier-uniform with gain 1e-4, bias -1e-4), so the
  adapted model starts as the frozen LM;
- :class:`AdapterGPT` -- a frozen ClipGPT, the adapter on its last hidden
  state, then the product with ``lm_head_table()`` into f32 logits over the
  global CLIP vocabulary; only the adapter trains;
- :func:`init_lora_params`, :func:`apply_lora`, :class:`LoRAGPT` -- LoRA A/B
  factors on every ``c_attn`` / ``c_proj`` kernel of the GPT core, merged
  functionally on each call (``kernel + scale * A @ B``): the base weights
  stay frozen and only the factors train.

A proposer's parameters are a flat dict of leaf tensors named by their path
in the JAX package's tree (``fc1.kernel``, ``core.h_0.attn.c_attn.kernel.a``),
which is what the port's optimizers take; :func:`from_flax_params` carries a
JAX adapter or LoRA tree (as numpy arrays) into that form. Random draws come
from an explicit CPU ``torch.Generator`` and are copied to the model's device.

A proposer is called one position at a time over a KV cache. Its parameters
feed every step, so the cache's new keys and values require grad and the
port's GPT-2 writes them out of place (``models/gpt2.py``): autograd keeps
each step's buffer. The cached steps run plain products and plain attention
(``use_flash=False``), as in the JAX package; no kernel of the port is on
this path.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from summer_clip_torch.core.device import resolve_device
from summer_clip_torch.models.gpt2 import Cache, ClipGPT

__all__ = ["EmbsAdapter", "AdapterGPT", "init_lora_params", "apply_lora", "LoRAGPT",
           "from_flax_params", "flatten", "unflatten"]

Params = tp.Dict[str, torch.Tensor]


def flatten(tree: tp.Mapping[str, tp.Any], prefix: str = "") -> tp.Dict[str, tp.Any]:
    """A nested dict as ``{"a.b.c": leaf}``."""
    out: tp.Dict[str, tp.Any] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, tp.Mapping):
            out.update(flatten(v, name + "."))
        else:
            out[name] = v
    return out


def unflatten(flat: tp.Mapping[str, tp.Any]) -> tp.Dict[str, tp.Any]:
    """The inverse of :func:`flatten`."""
    out: tp.Dict[str, tp.Any] = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def from_flax_params(tree: tp.Mapping[str, tp.Any], device=None,
                     requires_grad: bool = True) -> Params:
    """A JAX adapter or LoRA tree with numpy leaves -> the port's flat
    parameters (f32 copies on ``device``, the card when None)."""
    device = resolve_device(device)
    return {k: torch.tensor(np.asarray(v, np.float32), device=device).requires_grad_(requires_grad)
            for k, v in flatten(tree).items()}


def _rlprompt_uniform(shape: tp.Tuple[int, int], generator: torch.Generator) -> torch.Tensor:
    """xavier_uniform with gain 1e-4: a near-zero start (gpt_logits.py:20-26)."""
    limit = 1e-4 * math.sqrt(6.0 / (shape[0] + shape[1]))
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * limit


class EmbsAdapter:
    """``relu(x @ fc1 + b1) @ fc2 + b2 + x`` on parameters named as the JAX
    module's (``fc1.kernel`` (d, hidden), ``fc1.bias``, ``fc2.kernel``,
    ``fc2.bias``)."""

    def __init__(self, hidden_dim: int):
        self.hidden_dim = hidden_dim

    def init(self, d: int, generator: torch.Generator, device=None) -> Params:
        """Drawn on the host from ``generator``, then put on ``device`` (the
        card when None)."""
        device = resolve_device(device)
        h = self.hidden_dim
        params = {"fc1.kernel": _rlprompt_uniform((d, h), generator),
                  "fc1.bias": torch.full((h,), -1e-4),
                  "fc2.kernel": _rlprompt_uniform((h, d), generator),
                  "fc2.bias": torch.full((d,), -1e-4)}
        return {k: v.to(device).requires_grad_() for k, v in params.items()}

    @staticmethod
    def apply(params: Params, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(x @ params["fc1.kernel"] + params["fc1.bias"])
        return h @ params["fc2.kernel"] + params["fc2.bias"] + x


def _device(gpt: ClipGPT) -> torch.device:
    return gpt.core.ln_f.scale.device


class AdapterGPT:
    """Frozen ClipGPT + residual adapter on the final hidden state.

    ``__call__(adapter_params, clip_space_embeds, cache)`` returns
    (last-position f32 logits over the CLIP vocabulary (B, 1, V), new cache).
    Only ``adapter_params`` train. The head table does not depend on them,
    so it is computed once, without grad, and reused.
    """

    def __init__(self, gpt_model: ClipGPT, hidden_dim: int):
        self.gpt = gpt_model
        self.adapter = EmbsAdapter(hidden_dim)
        self._table: tp.Optional[torch.Tensor] = None

    def init(self, generator: torch.Generator) -> Params:
        return self.adapter.init(self.gpt.config.n_embd, generator, _device(self.gpt))

    def init_cache(self, batch: int, max_len: int) -> Cache:
        return self.gpt.init_cache(batch, max_len)

    def head_table(self) -> torch.Tensor:
        if self._table is None:
            with torch.no_grad():
                self._table = self.gpt.lm_head_table()
        return self._table

    def __call__(self, adapter_params: Params, inputs_embeds: torch.Tensor,
                 cache: tp.Optional[Cache] = None) -> tp.Tuple[torch.Tensor, tp.Optional[Cache]]:
        out = self.gpt(inputs_embeds=inputs_embeds, cache=cache, compute_logits=False)
        hidden = self.adapter.apply(adapter_params, out["hidden"][:, -1, :].float())
        logits = hidden @ self.head_table().t().float()
        return logits[:, None, :], out["cache"]


def _is_target(path: tp.Sequence[str], target_suffixes: tp.Sequence[str]) -> bool:
    return len(path) >= 2 and path[-1] == "kernel" and path[-2] in target_suffixes


def init_lora_params(params: tp.Mapping[str, tp.Any], generator: torch.Generator,
                     rank: int = 8,
                     target_suffixes: tp.Sequence[str] = ("c_attn", "c_proj"),
                     device=None) -> Params:
    """LoRA factors for every dense kernel whose parent module is one of
    ``target_suffixes`` (so ``attn.c_proj``, not ``mlp_c_proj``): ``a`` (in,
    rank) ~ N(0, 1) / rank, ``b`` (rank, out) zero, so the merged model starts
    as the base. Flat names ``<kernel path>.a`` / ``.b``; the draws follow the
    tree's order of the kernels, on the host; the factors then go to
    ``device`` (the card when None)."""
    device = resolve_device(device)
    out: Params = {}
    for name, leaf in flatten(params).items():
        if not _is_target(name.split("."), target_suffixes):
            continue
        d_in, d_out = leaf.shape
        out[f"{name}.a"] = torch.randn((d_in, rank), generator=generator) * (1.0 / rank)
        out[f"{name}.b"] = torch.zeros((rank, d_out))
    return {k: v.to(device).requires_grad_() for k, v in out.items()}


def apply_lora(params: tp.Mapping[str, tp.Any], lora: Params, scale: float = 1.0
               ) -> tp.Dict[str, tp.Any]:
    """Functionally merge LoRA deltas into a nested tree: every kernel with
    factors ``<path>.a`` / ``<path>.b`` in ``lora`` (as :func:`init_lora_params`
    names them) becomes ``kernel + scale * (a @ b)``; other leaves pass
    through."""
    flat = flatten(params)
    for name in (k[:-len(".a")] for k in lora if k.endswith(".a")):
        flat[name] = flat[name] + scale * (lora[f"{name}.a"] @ lora[f"{name}.b"])
    return unflatten(flat)


class LoRAGPT:
    """ClipGPT with LoRA on the attention projections; only the factors train.

    ``__call__(lora_params, clip_space_embeds, cache)`` runs the model on the
    merged tree (``torch.func.functional_call``: the module's parameters are
    not touched) and returns (last-position f32 logits (B, 1, V), new cache)."""

    def __init__(self, gpt_model: ClipGPT, rank: int = 8, scale: float = 1.0,
                 target_suffixes: tp.Sequence[str] = ("c_attn", "c_proj")):
        self.gpt = gpt_model
        self.rank = rank
        self.scale = scale
        self.target_suffixes = tuple(target_suffixes)

    def init(self, generator: torch.Generator) -> Params:
        return init_lora_params(self.gpt.tree(), generator, self.rank, self.target_suffixes,
                                device=_device(self.gpt))

    def init_cache(self, batch: int, max_len: int) -> Cache:
        return self.gpt.init_cache(batch, max_len)

    def __call__(self, lora_params: Params, inputs_embeds: torch.Tensor,
                 cache: tp.Optional[Cache] = None) -> tp.Tuple[torch.Tensor, tp.Optional[Cache]]:
        merged = flatten(apply_lora(self.gpt.tree(), lora_params, self.scale))
        out = torch.func.functional_call(self.gpt, merged, (),
                                         {"inputs_embeds": inputs_embeds, "cache": cache})
        return out["logits"][:, -1:, :], out["cache"]
