"""Megatron tensor-parallel decode with the products on each rank's slices.

Counterpart of ``summer_clip_tpu/parallel/tp_int8.py``. The JAX package runs
its int8 TP decoder as explicit SPMD inside ``shard_map``; here each rank is a
process that holds its slices and runs the same local forward:

- the int8 weight slabs and their per-column scales split the Megatron way
  over the mesh's ``model`` axis: column-parallel ``c_attn`` / ``mlp_c_fc``
  (their biases sliced alike), with the fused qkv columns PERMUTED so that
  each rank's contiguous slice is ``[q_s | k_s | v_s]`` (a contiguous split of
  ``[q | k | v]`` would give rank 0 all of q); row-parallel ``c_proj`` /
  ``mlp_c_proj`` with their scales whole (they index output columns, which a
  row split keeps) and their biases added once, after the all-reduce;
- :class:`TPInt8Decoder`: each rank streams its own slices through the
  products of ``models/gpt2`` (``qdot``: K7 for a decode-shaped call on an int8
  slice; the plain product of a float tree, which is the math of the JAX
  package's GSPMD route for that tree), attends over its local heads against
  its local KV ring (``n_embd / tp`` wide), and all-reduces the row-parallel
  partial outputs; embeddings, adapters, LayerNorms and the head run on
  replicated leaves.

The decoder has the surface the samplers (``apps/gen_gpt``) and the serving
engine (``engine/serving``) call: ``config``, ``init_cache``, and the model's
call with token ids or CLIP-space embeds, scalar or per-row cache indices,
``key_pad`` and ``compute_logits``; its cache semantics are
``models/gpt2.GPT2Attention``'s (same masks, same in-place writes). At
``tp = 1`` it is the one-device forward operation for operation. K8 (the
megakernel) and K10 (the fused-MLP opt-in) are not used under TP, as in the
JAX package. Every rank computes the same logits bit for bit (the all-reduce
gives every rank the same sums, the rest is replicated), so ranks that sample
with generators seeded alike pick the same ids.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from summer_clip_torch.models import gpt2 as gpt2_mod
from summer_clip_torch.ops.attention import multi_head_attention
from summer_clip_torch.ops.block_kernels import ln_f32
from summer_clip_torch.ops.gemv import QLeaf, gather_rows, is_qleaf
from summer_clip_torch.parallel.mesh import Mesh, all_reduce
from summer_clip_torch.parallel.tp import check_tp_divisibility

__all__ = ["permute_qkv_columns", "shard_decode_tp_int8", "TPInt8Decoder", "tp_int8_decoder",
           "tp_int8_spec"]


def _qkv_perm(d: int, tp_size: int) -> np.ndarray:
    """Column permutation of a fused (.., 3D) qkv matrix so that the
    contiguous slice s holds ``[q_s | k_s | v_s]``."""
    dl = d // tp_size
    perm = []
    for s in range(tp_size):
        for part in range(3):                   # q, k, v blocks
            base = part * d + s * dl
            perm.extend(range(base, base + dl))
    return np.asarray(perm, np.int64)


def permute_qkv_columns(leaf, d: int, tp_size: int):
    """The qkv permutation applied to a kernel leaf (int8 :class:`QLeaf` or
    plain tensor) or a 1-D bias."""
    perm = torch.from_numpy(_qkv_perm(d, tp_size))
    if is_qleaf(leaf):
        return QLeaf(leaf.q[..., perm.to(leaf.q.device)], leaf.scale[..., perm.to(leaf.q.device)])
    return leaf[..., perm.to(leaf.device)]


def tp_int8_spec(path: tp.Sequence[str], leaf) -> tp.Tuple[tp.Optional[str], ...]:
    """The spec of one decode-tree leaf; an int8 leaf appears as its ``q`` and
    ``scale`` sub-leaves. The JAX package's ``_tp_int8_spec``."""
    names = [str(n) for n in path]
    col = any(n in ("c_attn", "mlp_c_fc") for n in names)
    row = any(n in ("c_proj", "mlp_c_proj") for n in names)
    leafname = names[-1] if names else ""
    nd = len(getattr(leaf, "shape", ()))
    if col:
        if leafname in ("q", "kernel", "scale") and nd == 2:
            return (None, "model")
        if leafname == "bias":
            return ("model",)
    if row and leafname in ("q", "kernel") and nd == 2:
        return ("model", None)
    # row-parallel scales index output columns, and biases are added once after
    # the all-reduce: replicated
    return ()


def _take(x: torch.Tensor, spec, tp_size: int, idx: int) -> torch.Tensor:
    for dim, axis in enumerate(spec):
        if axis == "model":
            per = x.shape[dim] // tp_size
            x = x.narrow(dim, idx * per, per)
    return x.contiguous() if spec and "model" in spec else x


def _slice(path: tp.Tuple[str, ...], leaf, tp_size: int, idx: int):
    if is_qleaf(leaf):
        q = _take(leaf.q, tp_int8_spec(path + ("q",), leaf.q), tp_size, idx)
        s = _take(leaf.scale, tp_int8_spec(path + ("scale",), leaf.scale), tp_size, idx)
        return QLeaf(q, s)
    return _take(leaf, tp_int8_spec(path, leaf), tp_size, idx)


def shard_decode_tp_int8(tree: tp.Mapping[str, tp.Any], mesh: Mesh) -> tp.Dict[str, tp.Any]:
    """This rank's decode tree: ``tree`` (``model.tree()``, int8 or float)
    with the c_attn columns permuted, then c_attn / mlp_c_fc column-sliced and
    c_proj / mlp_c_proj row-sliced for the rank's place on the ``model`` axis;
    every other leaf is the tree's own (shared, not copied)."""
    tp_size, idx = mesh.shape["model"], mesh.coords["model"]

    def walk(node, path):
        if isinstance(node, tp.Mapping):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if "c_attn" in path and path[-1] in ("kernel", "bias"):
            width = node.q.shape[-1] if is_qleaf(node) else node.shape[-1]
            node = permute_qkv_columns(node, width // 3, tp_size)
        return _slice(path, node, tp_size, idx)

    return walk(tree, ())


def _dense(x: torch.Tensor, node: tp.Mapping[str, tp.Any], dtype: torch.dtype,
           bias: bool = True) -> torch.Tensor:
    return gpt2_mod._dense_apply(x, node["kernel"], node["bias"] if bias else None, dtype)


def _attend_cached(q, k, v, cache: dict, mask, nh_local: int):
    """``GPT2Attention``'s incremental decode on the local heads: the new keys
    and values written into the ring in place (per-row or scalar index)."""
    idx = cache["index"]
    s_new = q.shape[1]
    kc, vc = k.to(cache["k"].dtype), v.to(cache["v"].dtype)
    if isinstance(idx, torch.Tensor) and idx.dim() == 1:
        rows = torch.arange(q.shape[0], device=q.device)[:, None]
        start = idx.clamp(max=cache["k"].shape[1] - s_new)
        slots = start[:, None] + torch.arange(s_new, device=q.device)[None, :]
        cache["k"][rows, slots] = kc
        cache["v"][rows, slots] = vc
    else:
        cache["k"][:, idx:idx + s_new] = kc
        cache["v"][:, idx:idx + s_new] = vc
    o = multi_head_attention(q, cache["k"], cache["v"], num_heads=nh_local, mask=mask,
                             use_flash=False)
    return o, {"k": cache["k"], "v": cache["v"], "index": idx + s_new}


def core_forward_local(config, nh_local: int, core: tp.Mapping[str, tp.Any], x: torch.Tensor,
                       position_offset, cache, key_pad, mesh: tp.Optional[Mesh],
                       dtype: torch.dtype):
    """One decode forward on this rank's slices: replicated residual stream,
    local qkv, attention and hidden, an all-reduce after each row-parallel
    product, its bias added after the sum. Returns (ln_f output, cache)."""
    t = x.shape[1]
    positions = (position_offset + torch.arange(t, device=x.device)).clamp(
        0, config.n_positions - 1)
    x = x.to(dtype) + gather_rows(core["wpe"], positions).to(dtype)
    mask = gpt2_mod.cache_mask(cache[0]["index"], t, cache[0]["k"].shape[1], key_pad, x.device)
    new_cache = []
    for i in range(config.n_layer):
        blk = core[f"h_{i}"]
        attn = blk["attn"]
        u = ln_f32(x, blk["ln_1"]["scale"], blk["ln_1"]["bias"], 1e-5)
        q, k, v = _dense(u, attn["c_attn"], dtype).chunk(3, dim=-1)
        o, nc = _attend_cached(q, k, v, cache[i], mask, nh_local)
        new_cache.append(nc)
        proj = all_reduce(_dense(o, attn["c_proj"], dtype, bias=False), mesh)
        x = x + (proj + attn["c_proj"]["bias"].to(proj.dtype))
        u2 = ln_f32(x, blk["ln_2"]["scale"], blk["ln_2"]["bias"], 1e-5)
        hid = F.gelu(_dense(u2, blk["mlp_c_fc"], dtype), approximate="tanh")
        m = all_reduce(_dense(hid, blk["mlp_c_proj"], dtype, bias=False), mesh)
        x = x + (m + blk["mlp_c_proj"]["bias"].to(m.dtype))
    return ln_f32(x, core["ln_f"]["scale"], core["ln_f"]["bias"], 1e-5), new_cache


class TPInt8Decoder:
    """The decode forward of a GPT2 / ClipGPT whose block stack is split over
    the mesh's ``model`` axis; ``model`` holds the whole tree (int8 or float)
    and keeps serving the replicated parts (embeddings, adapters, the head).
    Called as the model is: ``decoder(ids | inputs_embeds=,
    position_offset=, cache=, key_pad=, compute_logits=)`` -> ``{"logits",
    "hidden", "cache"}``."""

    def __init__(self, model, mesh: Mesh):
        self.model = model
        self.config = model.config
        self.dtype = model.dtype
        self.core = model.core          # its device, and the replicated wpe / ln_f
        self.mesh = mesh
        tp_size = mesh.shape["model"]
        check_tp_divisibility(self.config.n_embd, self.config.n_head, tp_size)
        self.nh_local = self.config.n_head // tp_size
        self.local = shard_decode_tp_int8(model.tree()["core"], mesh)

    def init_cache(self, batch: int, max_len: int):
        """This rank's KV rings: the embedding dim split as c_attn's columns."""
        width = self.config.n_embd // self.mesh.shape["model"]
        dev = self.core.ln_f.scale.device
        return [{"k": torch.zeros(batch, max_len, width, dtype=self.dtype, device=dev),
                 "v": torch.zeros(batch, max_len, width, dtype=self.dtype, device=dev),
                 "index": 0} for _ in range(self.config.n_layer)]

    def head_logits(self, h: torch.Tensor) -> torch.Tensor:
        """The logits of replicated hidden rows, as the model computes them."""
        if isinstance(self.model, gpt2_mod.ClipGPT):
            return gpt2_mod.logits_f32(h, self.model.lm_head_table())
        return self.model.head_logits(h)

    def eval(self) -> "TPInt8Decoder":
        return self

    def __call__(self, input_ids: tp.Optional[torch.Tensor] = None,
                 inputs_embeds: tp.Optional[torch.Tensor] = None,
                 position_offset: tp.Union[int, torch.Tensor] = 0, cache=None,
                 key_pad: tp.Optional[torch.Tensor] = None,
                 compute_logits: bool = True) -> tp.Dict[str, tp.Any]:
        if cache is None:
            raise ValueError("TPInt8Decoder is a decode path: it needs a cache")
        base = self.model
        if isinstance(base, gpt2_mod.ClipGPT):
            if inputs_embeds is None:
                inputs_embeds = base.embed(input_ids)
            x = base.adapt_embeds(inputs_embeds)
        else:
            x = (inputs_embeds if inputs_embeds is not None
                 else gather_rows(base.wte.embedding, input_ids))
        h, new_cache = core_forward_local(self.config, self.nh_local, self.local, x,
                                          position_offset, cache, key_pad, self.mesh, self.dtype)
        logits = self.head_logits(h) if compute_logits else None
        return {"logits": logits, "hidden": h, "cache": new_cache}


def tp_int8_decoder(model, mesh: Mesh) -> TPInt8Decoder:
    """The decoder of ``model`` over ``mesh``'s model axis; ``model`` itself
    when it is one already. The decoder holds this rank's slices, so a caller
    cuts them once and keeps it (the engine, ``gen_gpt``'s generator); nothing
    here keeps a decoder alive."""
    return model if isinstance(model, TPInt8Decoder) else TPInt8Decoder(model, mesh)
