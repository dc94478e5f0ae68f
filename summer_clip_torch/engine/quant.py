"""Weight compression for the decode path (parameter-read-bound serving).

Counterpart of ``summer_clip_tpu/engine/quant.py``. Single-stream KV-cached
decode reads every parameter once per token, so the parameters' stored bytes
are the work. Two weight-only levers (activations and the KV cache untouched,
no calibration data):

- :func:`cast_params` -- store float matrices in bf16;
- :func:`quantize_tree` -- symmetric int8 with an f32 scale per output column
  for matrix leaves, per row for the gather tables (``embedding``, ``wpe``,
  ``clip_emb``: one outlier token then widens only its own step); ``bias`` and
  ``scale`` leaves stay f32. The result is consumed as stored: ``QDense``
  streams int8 through K7, embeddings gather int8 rows, and decode loops read
  logits off a hoisted int8 head table (:func:`quant_head_table`).

Trees are nested dicts of tensors with the JAX package's paths
(``models/gpt2``); a quantised leaf is a
:class:`~summer_clip_torch.ops.gemv.QLeaf`. The arithmetic is the JAX
package's, operation for operation in f32 (``round`` is half-to-even in both),
so the same numbers give the same ``q`` and ``scale`` bit for bit.
"""

from __future__ import annotations

import typing as tp

import torch

from summer_clip_torch.ops.gemv import QLeaf, is_qleaf

__all__ = ["cast_params", "quantize_tree", "quantize_array", "dequantize_tree",
           "quant_head_table", "map_tree"]

_SENSITIVE = ("bias", "scale")                  # LayerNorm/bias leaves: keep f32
_EMBED_NAMES = ("embedding", "wpe", "clip_emb")  # gather tables: scale per row


def map_tree(fn: tp.Callable[[tp.Tuple[str, ...], tp.Any], tp.Any], tree: tp.Any,
             path: tp.Tuple[str, ...] = ()) -> tp.Any:
    """``fn(path, leaf)`` over a nested dict; a ``QLeaf`` is one leaf."""
    if isinstance(tree, tp.Mapping):
        return {k: map_tree(fn, v, path + (str(k),)) for k, v in tree.items()}
    return fn(path, tree)


def _is_matrix(name: str, x: tp.Any) -> bool:
    return (isinstance(x, torch.Tensor) and x.is_floating_point() and x.dim() >= 2
            and name not in _SENSITIVE)


def cast_params(params, dtype: torch.dtype = torch.bfloat16):
    """Cast float matrix leaves to ``dtype``; small and sensitive leaves stay."""
    return map_tree(lambda path, x: x.to(dtype) if _is_matrix(path[-1] if path else "", x) else x,
                    params)


def quantize_array(x: torch.Tensor, *, per_row: bool = False) -> QLeaf:
    """int8-quantise one array: per-output-column scale (last axis kept), or
    per-row scale for gather tables."""
    x = x.to(torch.float32)
    if per_row:
        amax = x.abs().amax(dim=-1, keepdim=True)
    else:
        amax = x.abs().amax(dim=tuple(range(x.dim() - 1)), keepdim=True)
    # times the f32 reciprocal, not a division: what the JAX package's jitted
    # program computes (XLA turns a division by a constant into this product)
    scale = amax.clamp_min(1e-12) * (1.0 / 127.0)
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return QLeaf(q, scale)


def quantize_tree(params):
    """int8-quantise float matrix leaves; everything else passes through."""
    def quant(path, x):
        name = path[-1] if path else ""
        if _is_matrix(name, x):
            return quantize_array(x, per_row=name in _EMBED_NAMES)
        return x
    return map_tree(quant, params)


def dequantize_tree(qparams, dtype: torch.dtype = torch.bfloat16):
    """Rebuild a dense tree (outside any hot loop)."""
    return map_tree(lambda path, x: x.dequantize(dtype) if is_qleaf(x) else x, qparams)


@torch.no_grad()
def quant_head_table(model) -> QLeaf:
    """The int8 lm-head table in K7's layout: (n_embd, V) ``q``, (1, V) scale.

    ClipGPT's head is ``adapter_head(clip_emb)``, a 49k-row MLP. Decode loops
    compute it once before the loop and quantise it per vocab column; inside
    the loop it would run again every token. A plain GPT-2's tied head is the
    transposed ``wte`` (kept per row when it is int8 already)."""
    from summer_clip_torch.models import gpt2 as gpt2_mod

    if isinstance(model, gpt2_mod.ClipGPT):
        return quantize_array(model.lm_head_table().t().contiguous(), per_row=False)
    wte = model.wte.embedding
    if is_qleaf(wte):
        return QLeaf(wte.q.t().contiguous(), wte.scale.t().contiguous())
    return quantize_array(wte.t().contiguous(), per_row=False)
