"""Pipeline parallelism for the GPT block stack (GPipe over a ``stage`` axis),
and the stacked block layout.

Counterpart of ``summer_clip_tpu/parallel/pp.py``:

- GPT-2 blocks are homogeneous, so per-layer leaves stack into one tree
  with a leading ``(n_stages, layers_per_stage)`` shape
  (:func:`stack_block_params`, undone by :func:`unstack_block_params`);
  :func:`shard_stacked_pp` gives a rank its stage's ``(1, L/S, ...)`` chunk;
- :func:`pipeline_blocks` keeps the JAX package's SPMD form: over ``M + S -
  1`` ticks every stage runs its chunk, stage 0 on microbatch ``clip(t)``
  (``torch.where`` on the stage index, so that every rank's autograd graph
  has the same shape and its collectives run in the same order), and each
  tick's output moves one stage on (``parallel.mesh.axis_shift``, the
  ``ppermute``: an all-gather, its backward the reverse shift). The last
  stage's outputs are kept, the other stages' zeroed and summed over the
  axis (``axis_sum``, identity backward), so every rank holds the
  activations. The input passes ``axis_copy`` first: only stage 0 reads it,
  so its gradient summed over the stages is the dense one on every rank, and
  the leaves of the stem (``wte`` / ``clip_emb``, the emb adapter) get the
  same gradient on every stage, as the head's leaves do;
- ``data_axis`` composes it with data parallelism on a ``('data',
  'stage')`` mesh: a rank holds its data rows and its data row runs its own
  pipeline over its stage column (microbatches split from the local rows);
- :func:`pp_gpt2_forward` / :func:`pp_clip_gpt_forward`: the LM forwards
  with the stem and head replicated and the blocks staged;
  :func:`scan_gpt2_forward` / :func:`scan_clip_gpt_forward`: the block stack
  as one loop over the stacked leading axis (the JAX package's ``lax.scan``;
  the same math as the unrolled model).

Every block runs ``parallel.tp.tp_block_forward`` on whole leaves (K4 on the
card), under ``torch.utils.checkpoint`` when ``remat`` is on (the JAX
``jax.checkpoint`` per layer), so a staged block launches K4 again in the
backward.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from summer_clip_torch.parallel.mesh import axis_copy, axis_shift, axis_sum

__all__ = ["stack_block_params", "unstack_block_params", "pipeline_blocks", "pp_gpt2_forward",
           "pp_clip_gpt_forward", "check_pp_divisibility", "scan_gpt2_forward",
           "scan_clip_gpt_forward", "shard_stacked_pp", "block_keys", "gpt2_stem", "gpt2_head",
           "clip_gpt_stem", "clip_gpt_head"]

Tree = tp.Dict[str, tp.Any]


def check_pp_divisibility(n_layer: int, n_stages: int) -> None:
    if n_layer % n_stages != 0:
        raise ValueError(f"n_layer {n_layer} not divisible by {n_stages} stages")


def block_keys(core: tp.Mapping[str, tp.Any]) -> tp.List[str]:
    """``h_0``, ``h_1``, ... of a core tree, in layer order."""
    return sorted((k for k in core if k.startswith("h_")), key=lambda k: int(k.split("_")[1]))


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure; an empty dict (a
    masked leaf of an optax state) stays an empty dict."""
    first = trees[0]
    if isinstance(first, tp.Mapping) and first:
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, tp.Mapping):
        return {}
    return fn(*trees)


def stack_block_params(params: tp.Mapping[str, tp.Any], n_stages: int) -> tp.Tuple[Tree, Tree]:
    """Split a GPT-2 / ClipGPT tree into (non-block, stacked block) trees: the
    blocks ``core/h_{i}`` stack to ``(n_stages, layers_per_stage, ...)``.
    ``torch.stack``: differentiable, and a copy."""
    core = dict(params["core"])
    keys = block_keys(core)
    n_layer = len(keys)
    check_pp_divisibility(n_layer, n_stages)
    blocks = [core.pop(k) for k in keys]
    stacked = _map(lambda *xs: torch.stack(xs).reshape((n_stages, n_layer // n_stages)
                                                       + tuple(xs[0].shape)), *blocks)
    rest = dict(params)
    rest["core"] = core
    return rest, stacked


def unstack_block_params(rest: tp.Mapping[str, tp.Any], stacked: tp.Any) -> Tree:
    """Inverse of :func:`stack_block_params` (checkpoint interchange); also
    the unstacking of a stacked optax tree, whose masked leaves are empty
    dicts."""
    shape = None

    def find(node):
        nonlocal shape
        if isinstance(node, tp.Mapping):
            for v in node.values():
                find(v)
        elif shape is None:
            shape = tuple(node.shape[:2])

    find(stacked)
    core = dict(rest["core"])
    s, lps = shape or (0, 0)      # every leaf masked: no block holds a tensor
    for i in range(s * lps):
        core[f"h_{i}"] = _map(lambda x: x.reshape((s * lps,) + tuple(x.shape[2:]))[i], stacked)
    out = dict(rest)
    out["core"] = core
    return out


def shard_stacked_pp(stacked: tp.Any, mesh, axis: str = "stage") -> Tree:
    """This rank's ``(1, L/S, ...)`` chunk of a stacked tree (the JAX
    ``P(axis)`` placement's shard)."""
    i = mesh.coords[axis]
    return _map(lambda x: x[i:i + 1], stacked)


def _unbind(chunk: Tree) -> tp.List[Tree]:
    """A ``(L, ...)`` chunk as L block trees (one ``unbind`` a leaf, whose
    backward stacks the gradients once)."""
    flat: tp.List[tp.Tuple[tp.Tuple[str, ...], tp.List[torch.Tensor]]] = []

    def walk(node, path):
        if isinstance(node, tp.Mapping):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            flat.append((path, node.unbind(0)))

    walk(chunk, ())
    layers = []
    for i in range(len(flat[0][1])):
        tree: Tree = {}
        for path, parts in flat:
            cur = tree
            for k in path[:-1]:
                cur = cur.setdefault(k, {})
            cur[path[-1]] = parts[i]
        layers.append(tree)
    return layers


def _layer(num_heads, dtype, x, p):
    from summer_clip_torch.parallel.tp import tp_block_forward

    return tp_block_forward(p, x, num_heads=num_heads, dtype=dtype)


def block_chunk(chunk: Tree, x: torch.Tensor, *, num_heads: int, dtype: torch.dtype,
                remat: bool = False) -> torch.Tensor:
    """This stage's blocks (leaves ``(L', ...)``) applied in order; each
    under ``torch.utils.checkpoint`` with ``remat``."""
    remat = remat and torch.is_grad_enabled()
    for p in _unbind(chunk):
        if remat:
            x = torch.utils.checkpoint.checkpoint(_layer, num_heads, dtype, x, p,
                                                  use_reentrant=False)
        else:
            x = _layer(num_heads, dtype, x, p)
    return x


def pipeline_blocks(stacked_params: Tree, x: torch.Tensor, mesh, *, num_heads: int,
                    n_microbatches: int, axis: str = "stage", dtype=torch.float32,
                    remat: bool = False, data_axis: tp.Optional[str] = None) -> torch.Tensor:
    """(B, T, D) -> (B, T, D) through the staged block stack.

    ``stacked_params`` is this rank's ``(1, L/S, ...)`` chunk
    (:func:`shard_stacked_pp`). ``data_axis=None``: ``x`` is the whole batch
    on every rank; ``data_axis='data'``: ``x`` is this rank's rows of the
    batch sharded over ``data``, and its data row runs its own pipeline."""
    s = mesh.size(axis)
    m = n_microbatches
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} (a {data_axis or 'whole'} shard) not divisible by "
                         f"{m} microbatches")
    stage = mesh.coords.get(axis, 0)
    chunk = _map(lambda p: p[0], stacked_params)
    x = axis_copy(x, mesh, axis)
    x_all = x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(stage == s - 1, device=x.device)
    recv = torch.zeros_like(x_all[0])
    outs = []
    ticks = m + s - 1
    for t in range(ticks):
        inp = torch.where(first, x_all[min(t, m - 1)], recv)
        out = block_chunk(chunk, inp, num_heads=num_heads, dtype=dtype, remat=remat)
        outs.append(out)
        if t < ticks - 1:
            recv = axis_shift(out, mesh, axis)
    result = torch.stack(outs[s - 1:s - 1 + m])
    result = axis_sum(torch.where(last, result, torch.zeros_like(result)), mesh, axis)
    return result.reshape(x.shape)


# ---------------------------------------------------------------------------
# stems and heads on the non-block tree (``models/gpt2``'s math)
# ---------------------------------------------------------------------------
def _positions(rest: Tree, x: torch.Tensor, dtype) -> torch.Tensor:
    from summer_clip_torch.ops.gemv import gather_rows

    wpe = rest["core"]["wpe"]
    pos = torch.arange(x.shape[1], device=x.device).clamp(0, wpe.shape[0] - 1)
    return x.to(dtype) + gather_rows(wpe, pos).to(dtype)


def _final_ln(rest: Tree, x: torch.Tensor) -> torch.Tensor:
    from summer_clip_torch.ops.block_kernels import ln_f32

    return ln_f32(x, rest["core"]["ln_f"]["scale"], rest["core"]["ln_f"]["bias"], 1e-5)


def gpt2_stem(model, rest: Tree, input_ids: torch.Tensor) -> torch.Tensor:
    """Token + position embedding (``GPT2.forward``'s front)."""
    from summer_clip_torch.ops.gemv import gather_rows

    return _positions(rest, gather_rows(rest["wte"]["embedding"], input_ids), model.dtype)


def gpt2_head(model, rest: Tree, x: torch.Tensor) -> torch.Tensor:
    """Final LN + tied-embedding logits in f32 (``GPT2.forward``'s tail)."""
    from summer_clip_torch.models.gpt2 import logits_f32

    return logits_f32(_final_ln(rest, x), rest["wte"]["embedding"])


def _adapter(rest: Tree, name: str, x: torch.Tensor, dtype) -> torch.Tensor:
    from summer_clip_torch.models.gpt2 import _dense_apply

    p = rest.get(name) or rest["adapter_emb"]    # a shared head adapter
    h = F.relu(_dense_apply(x, p["fc1"]["kernel"], None, dtype))
    return F.relu(_dense_apply(h, p["fc2"]["kernel"], None, dtype))


def clip_gpt_stem(model, rest: Tree, input_ids: torch.Tensor) -> torch.Tensor:
    """CLIP table -> emb adapter -> + positions (``ClipGPT.forward``'s front)."""
    from summer_clip_torch.ops.gemv import gather_rows

    x = _adapter(rest, "adapter_emb", gather_rows(rest["clip_emb"], input_ids).to(model.dtype),
                 model.dtype)
    return _positions(rest, x, model.dtype)


def clip_gpt_head(model, rest: Tree, x: torch.Tensor) -> torch.Tensor:
    """Final LN + the adapter LM head in f32 (``ClipGPT.forward``'s tail)."""
    from summer_clip_torch.models.gpt2 import logits_f32

    table = _adapter(rest, "adapter_head", rest["clip_emb"].to(model.dtype), model.dtype)
    return logits_f32(_final_ln(rest, x), table)


def _remat(model, remat: tp.Optional[bool]) -> bool:
    return model.core.remat if remat is None else bool(remat)


def pp_gpt2_forward(model, rest_params: Tree, stacked_params: Tree, input_ids: torch.Tensor,
                    mesh, *, n_microbatches: int, axis: str = "stage",
                    remat: tp.Optional[bool] = None,
                    data_axis: tp.Optional[str] = None) -> torch.Tensor:
    """GPT-2 LM logits with the block stack pipelined; embedding, positions,
    final LN and logits replicated. ``remat=None`` takes the model's."""
    x = gpt2_stem(model, rest_params, input_ids)
    x = pipeline_blocks(stacked_params, x, mesh, num_heads=model.config.n_head,
                        n_microbatches=n_microbatches, axis=axis, dtype=model.dtype,
                        remat=_remat(model, remat), data_axis=data_axis)
    return gpt2_head(model, rest_params, x)


def pp_clip_gpt_forward(model, rest_params: Tree, stacked_params: Tree,
                        input_ids: torch.Tensor, mesh, *, n_microbatches: int,
                        axis: str = "stage", remat: tp.Optional[bool] = None,
                        data_axis: tp.Optional[str] = None) -> torch.Tensor:
    """ClipGPT LM logits with the block stack pipelined; the CLIP table,
    adapters, positions, final LN and head replicated."""
    x = clip_gpt_stem(model, rest_params, input_ids)
    x = pipeline_blocks(stacked_params, x, mesh, num_heads=model.config.n_head,
                        n_microbatches=n_microbatches, axis=axis, dtype=model.dtype,
                        remat=_remat(model, remat), data_axis=data_axis)
    return clip_gpt_head(model, rest_params, x)


def scan_gpt2_forward(model, rest_params: Tree, stacked_params: Tree,
                      input_ids: torch.Tensor, *, remat: bool = False) -> torch.Tensor:
    """GPT-2 LM logits with the block stack as one loop over the stacked
    leading axis; ``stacked_params`` leaves ``(1, n_layer, ...)``
    (``stack_block_params(tree, 1)``, the pipeline's checkpoint layout)."""
    x = gpt2_stem(model, rest_params, input_ids)
    x = block_chunk(_map(lambda p: p[0], stacked_params), x, num_heads=model.config.n_head,
                    dtype=model.dtype, remat=remat)
    return gpt2_head(model, rest_params, x)


def scan_clip_gpt_forward(model, rest_params: Tree, stacked_params: Tree,
                          input_ids: torch.Tensor, *, remat: bool = False) -> torch.Tensor:
    """ClipGPT LM logits with the block stack scanned over its layers."""
    x = clip_gpt_stem(model, rest_params, input_ids)
    x = block_chunk(_map(lambda p: p[0], stacked_params), x, num_heads=model.config.n_head,
                    dtype=model.dtype, remat=remat)
    return clip_gpt_head(model, rest_params, x)
