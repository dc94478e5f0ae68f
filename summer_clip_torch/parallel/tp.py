"""Tensor-parallel slicing rules for the GPT family (Megatron layout).

Counterpart of ``summer_clip_tpu/parallel/tp.py``. The mesh's ``model`` axis
splits the transformer's matrices the Megatron way:

- ``c_attn`` / ``mlp_c_fc`` kernels: column-parallel ``(None, "model")``
  (heads and hidden units split over the ranks),
- attention ``c_proj`` / ``mlp_c_proj`` kernels: row-parallel
  ``("model", None)`` (the product's partial sums are all-reduced),
- embeddings, LayerNorms, biases and adapters: replicated ``()``.

A spec is the tuple the JAX ``PartitionSpec`` holds. The JAX package places
the Flax tree by these specs and lets GSPMD insert the collectives; the port
has no GSPMD, so each rank holds its slices and runs the collectives itself:

- :func:`shard_params_tp` (training): this rank's slice of every leaf by
  :func:`gpt2_tp_spec`, the fused qkv columns permuted first
  (``parallel/tp_int8.permute_qkv_columns``) so that a column slice is
  ``[q_s | k_s | v_s]``; biases stay whole, as the spec replicates them;
- :func:`tp_block_forward` runs a GPT-2 block on those slices: LayerNorm on
  the replicated residual, *f* (``parallel.mesh.axis_copy``), the column
  products with the rank's columns of their biases, attention over the
  rank's ``n_head / tp`` heads (K4 on the card), the row products, *g*
  (``axis_sum``), then the row-parallel bias once, after the sum. Every rank
  then holds the same residual, so every replicated leaf's gradient is the
  dense one on every rank; a column bias's gradient is the rank's part, and
  the trainer sums it over the axis once per update
  (:func:`tp_partial_leaf`);
- :func:`tp_gpt2_forward` / :func:`tp_clip_gpt_forward`: the LM forwards on a
  model whose blocks hold the rank's slices (stem and head replicated);
- :func:`shard_decode_tp` gives the decode side the layout of
  ``parallel/tp_int8`` (column-parallel biases sliced), which serves float
  and int8 trees alike.
"""

from __future__ import annotations

import functools
import typing as tp

import torch
import torch.nn.functional as F

__all__ = ["gpt2_tp_spec", "check_tp_divisibility", "shard_decode_tp", "shard_params_tp",
           "take_spec", "tp_block_forward", "tp_gpt2_forward", "tp_clip_gpt_forward",
           "tp_partial_leaf", "qkv_columns", "param_tree", "install_leaves", "block_stack"]

Spec = tp.Tuple[tp.Optional[str], ...]


def gpt2_tp_spec(path: tp.Sequence[str], leaf) -> Spec:
    """The spec of one GPT-2 parameter, by its tree path (names)."""
    names = [str(n) for n in path]
    if not names or names[-1] != "kernel" or len(getattr(leaf, "shape", ())) != 2:
        return ()
    if any(n in ("c_attn", "mlp_c_fc") for n in names):
        return (None, "model")    # column parallel
    if any(n in ("c_proj", "mlp_c_proj") for n in names):
        return ("model", None)    # row parallel
    return ()


def check_tp_divisibility(n_embd: int, n_head: int, tp_size: int) -> None:
    if tp_size <= 1:
        return
    if n_head % tp_size:
        raise ValueError(f"n_head {n_head} % tp {tp_size} != 0")
    if n_embd % tp_size:
        raise ValueError(f"n_embd {n_embd} % tp {tp_size} != 0")


def shard_decode_tp(tree: tp.Mapping[str, tp.Any], mesh) -> tp.Dict[str, tp.Any]:
    """This rank's decode tree of a float (or int8) GPT tree: the layout of
    :func:`parallel.tp_int8.shard_decode_tp_int8`, which the decoder of both
    trees (:class:`parallel.tp_int8.TPInt8Decoder`) reads."""
    from summer_clip_torch.parallel.tp_int8 import shard_decode_tp_int8

    return shard_decode_tp_int8(tree, mesh)


def take_spec(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``x``: each dim that ``spec`` assigns to an axis
    of ``mesh`` cut evenly over that axis, at the rank's coordinate."""
    for dim, axis in enumerate(spec):
        if axis is not None and mesh.size(axis) > 1:
            per = x.shape[dim] // mesh.size(axis)
            x = x.narrow(dim, mesh.coords[axis] * per, per)
    return x.contiguous()


def _is_qkv(path: tp.Sequence[str]) -> bool:
    return "c_attn" in path and path[-1] == "kernel"


def shard_params_tp(tree: tp.Mapping[str, tp.Any], mesh, axis: str = "model"
                    ) -> tp.Dict[str, tp.Any]:
    """This rank's training tree: every leaf cut by :func:`gpt2_tp_spec` over
    ``axis``, the c_attn kernels' columns permuted first (for a tp > 1); the
    replicated leaves are the tree's own tensors. The JAX package's
    ``shard_params_tp`` places the same specs without the permutation (GSPMD
    moves the columns); a rank's slice here is its shard of the permuted
    tree."""
    from summer_clip_torch.parallel.tp_int8 import permute_qkv_columns

    size = mesh.size(axis)

    def walk(node, path):
        if isinstance(node, tp.Mapping):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        spec = gpt2_tp_spec(path, node)
        if not spec or size == 1:
            return node
        if _is_qkv(path):
            node = permute_qkv_columns(node, node.shape[0], size)
        return take_spec(node, tuple(axis if a == "model" else a for a in spec), mesh)

    return walk(tree, ())


def qkv_columns(d: int, tp_size: int, index: int) -> torch.Tensor:
    """The fused qkv columns (of ``3 d``) that rank ``index`` of ``tp_size``
    holds after the permutation, in its order."""
    from summer_clip_torch.parallel.tp_int8 import _qkv_perm

    n = 3 * d // tp_size
    return torch.from_numpy(_qkv_perm(d, tp_size)[index * n:(index + 1) * n])


def tp_partial_leaf(path: tp.Sequence[str]) -> bool:
    """A whole leaf that a TP rank uses only in part (a column-parallel bias):
    its gradient on a rank is that part's, summed over the axis once per
    update."""
    return path[-1] == "bias" and any(n in ("c_attn", "mlp_c_fc") for n in path)


def tp_block_forward(p: tp.Mapping[str, tp.Any], x: torch.Tensor, *, num_heads: int,
                     dtype: torch.dtype, mesh=None, axis: str = "model") -> torch.Tensor:
    """One GPT-2 block (``models/gpt2.GPT2Block``'s math and rounding points)
    on this rank's slices ``p`` (a block tree from :func:`shard_params_tp`);
    with ``mesh=None`` or a tp of 1, the block on whole leaves."""
    from summer_clip_torch.models.gpt2 import _dense_apply
    from summer_clip_torch.ops.attention import multi_head_attention
    from summer_clip_torch.ops.block_kernels import ln_f32
    from summer_clip_torch.parallel.mesh import axis_copy, axis_sum

    size = 1 if mesh is None else mesh.size(axis)
    attn, fc, proj = p["attn"], p["mlp_c_fc"], p["mlp_c_proj"]
    d = x.shape[-1]

    def cols(bias, idx=None):
        if size == 1:
            return bias
        if idx is not None:
            return bias[idx.to(bias.device)]
        n = bias.shape[0] // size
        return bias.narrow(0, mesh.coords[axis] * n, n)

    u = ln_f32(x, p["ln_1"]["scale"], p["ln_1"]["bias"], 1e-5)
    if size > 1:
        u = axis_copy(u, mesh, axis)
    qkv_bias = cols(attn["c_attn"]["bias"],
                    qkv_columns(d, size, mesh.coords[axis]) if size > 1 else None)
    q, k, v = _dense_apply(u, attn["c_attn"]["kernel"], qkv_bias, dtype).split(d // size, dim=-1)
    o = multi_head_attention(q, k, v, num_heads=num_heads // size, causal=True)
    if size > 1:
        h = axis_sum(_dense_apply(o, attn["c_proj"]["kernel"], None, dtype), mesh, axis)
        h = h + attn["c_proj"]["bias"].to(dtype)
    else:
        h = _dense_apply(o, attn["c_proj"]["kernel"], attn["c_proj"]["bias"], dtype)
    x = x + h
    u = ln_f32(x, p["ln_2"]["scale"], p["ln_2"]["bias"], 1e-5)
    if size > 1:
        u = axis_copy(u, mesh, axis)
    hidden = F.gelu(_dense_apply(u, fc["kernel"], cols(fc["bias"]), dtype), approximate="tanh")
    if size > 1:
        m = axis_sum(_dense_apply(hidden, proj["kernel"], None, dtype), mesh, axis)
        m = m + proj["bias"].to(dtype)
    else:
        m = _dense_apply(hidden, proj["kernel"], proj["bias"], dtype)
    return x + m


def block_stack(model, x: torch.Tensor, block_fn) -> torch.Tensor:
    """``block_fn(tree of block i, x)`` over the model's blocks, each under
    ``torch.utils.checkpoint`` when the model trains with remat (the tree is
    read inside, so a gather there runs again in the backward)."""
    import torch.utils.checkpoint

    from summer_clip_torch.models.gpt2 import _remat_kwargs

    core = model.core
    remat = core.remat and torch.is_grad_enabled()
    for i in range(model.config.n_layer):
        block = getattr(core, f"h_{i}")
        fn = functools.partial(_apply_block, block, block_fn)
        if remat:
            x = torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False,
                                                  **_remat_kwargs(core.remat_policy))
        else:
            x = fn(x)
    return x


def param_tree(module) -> tp.Dict[str, tp.Any]:
    """A module's parameters as a nested dict (the tensors autograd tracks,
    where ``tree()`` gives their detached data)."""
    out: tp.Dict[str, tp.Any] = {n: p for n, p in module._parameters.items() if p is not None}
    for name, child in module._modules.items():
        if child is not None:
            out[name] = param_tree(child)
    return out


def install_leaves(module, tree: tp.Mapping[str, tp.Any]) -> None:
    """Put the leaves of ``tree`` into ``module`` as new parameters of their
    own shapes (a rank's slices or shards in place of whole leaves)."""
    from summer_clip_torch.models.gpt2 import _set_leaf

    for name, value in tree.items():
        if isinstance(value, tp.Mapping):
            install_leaves(getattr(module, name), value)
        else:
            _set_leaf(module, name, value)


def _apply_block(block, block_fn, x):
    return block_fn(param_tree(block), x)


def tp_gpt2_forward(model, input_ids: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """GPT-2 LM logits (f32) with every block on this rank's slices; the
    embedding, positions, final LN and tied head replicated."""
    from summer_clip_torch.parallel.pp import gpt2_head, gpt2_stem

    rest = param_tree(model)
    return gpt2_head(model, rest, block_stack(model, gpt2_stem(model, rest, input_ids),
                                              _tp_block_fn(model, mesh, axis)))


def tp_clip_gpt_forward(model, input_ids: torch.Tensor, mesh,
                        axis: str = "model") -> torch.Tensor:
    """ClipGPT LM logits (f32) with every block on this rank's slices; the
    CLIP table, adapters, positions and final LN replicated."""
    from summer_clip_torch.parallel.pp import clip_gpt_head, clip_gpt_stem

    rest = param_tree(model)
    return clip_gpt_head(model, rest, block_stack(model, clip_gpt_stem(model, rest, input_ids),
                                                  _tp_block_fn(model, mesh, axis)))


def _tp_block_fn(model, mesh, axis):
    return functools.partial(_tp_block, model.config.n_head, model.dtype, mesh, axis)


def _tp_block(num_heads, dtype, mesh, axis, p, x):
    return tp_block_forward(p, x, num_heads=num_heads, dtype=dtype, mesh=mesh, axis=axis)
