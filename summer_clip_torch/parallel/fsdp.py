"""ZeRO-3 / fully-sharded parameters over the ``data`` axis.

Counterpart of ``summer_clip_tpu/parallel/fsdp.py``. The JAX package only
*places* the tree: :func:`fsdp_spec` shards each large leaf's largest free
axis over ``data``, and XLA gathers every weight just in time for its product
and reduce-scatters its gradient. The port does that schedule itself:

- :func:`shard_params_fsdp` gives a rank its shard of every leaf by the same
  rules (:data:`FSDP_MIN_ELEMS` and below stay whole; with ``with_tp`` the
  Megatron spec of ``parallel/tp`` claims its axis first, giving 2-D
  ``data x model`` shards of the TP slices);
- :func:`fsdp_gather` rebuilds a tree's leaves for use
  (``parallel.mesh.axis_all_gather``: an all-gather whose backward sums the
  gradient over ``data`` and keeps the rank's shard). The trainer gathers a
  block's leaves inside the block's checkpointed function, so the whole
  weights live only while the block runs, and the backward of a remat run
  gathers them again; the gradients the optimizer reads, its accumulator and
  its Adam moments are the rank's shards.
"""

from __future__ import annotations

import typing as tp

from summer_clip_torch.parallel.mesh import axis_all_gather
from summer_clip_torch.parallel.tp import Spec, gpt2_tp_spec, shard_params_tp, take_spec

__all__ = ["fsdp_spec", "shard_params_fsdp", "FSDP_MIN_ELEMS", "fsdp_specs", "fsdp_gather"]

# Tensors smaller than this stay replicated: biases, LayerNorm parameters and
# small adapters cost more in collectives than they save in memory.
FSDP_MIN_ELEMS = 2 ** 14


def fsdp_spec(leaf, data_size: int, base: tp.Optional[Spec] = None, axis: str = "data",
              min_elems: int = FSDP_MIN_ELEMS) -> Spec:
    """The spec sharding ``leaf``'s largest free axis over ``axis``: the
    largest dim that ``base`` (a Megatron TP spec, say) leaves unclaimed and
    ``data_size`` divides. ``base`` (replicated on the rest) when the leaf has
    fewer than ``min_elems`` elements or nothing divides."""
    shape = tuple(int(d) for d in getattr(leaf, "shape", ()))
    entries = list(base or ()) + [None] * (len(shape) - len(base or ()))
    size = 1
    for d in shape:
        size *= d
    if not shape or size < min_elems:
        return tuple(entries) if any(e is not None for e in entries) else ()
    best = -1
    for i, (dim, taken) in enumerate(zip(shape, entries)):
        if taken is None and dim % data_size == 0 and (best < 0 or dim > shape[best]):
            best = i
    if best >= 0:
        entries[best] = axis
    return tuple(entries) if any(e is not None for e in entries) else ()


def fsdp_specs(tree: tp.Mapping[str, tp.Any], data_size: int, with_tp: bool = False,
               min_elems: int = FSDP_MIN_ELEMS) -> tp.Dict[str, tp.Any]:
    """The spec of every leaf of a whole tree, as a tree."""
    def walk(node, path):
        if isinstance(node, tp.Mapping):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        base = gpt2_tp_spec(path, node) if with_tp else None
        return fsdp_spec(node, data_size, base=base, min_elems=min_elems)

    return walk(tree, ())


def shard_params_fsdp(params: tp.Mapping[str, tp.Any], mesh, with_tp: bool = False,
                      min_elems: int = FSDP_MIN_ELEMS) -> tp.Dict[str, tp.Any]:
    """This rank's shard of every leaf of the whole tree ``params``: cut over
    ``data`` by :func:`fsdp_spec` and, with ``with_tp``, over ``model`` by the
    Megatron spec first (the qkv columns permuted, :func:`parallel.tp.
    shard_params_tp`)."""
    specs = fsdp_specs(params, mesh.size("data"), with_tp, min_elems)
    local = shard_params_tp(params, mesh) if with_tp else params

    def walk(node, spec):
        if isinstance(node, tp.Mapping):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        return take_spec(node, tuple(a if a == "data" else None for a in spec), mesh)

    return walk(local, specs)


def fsdp_gather(tree: tp.Mapping[str, tp.Any], specs: tp.Mapping[str, tp.Any], mesh,
                axis: str = "data") -> tp.Dict[str, tp.Any]:
    """Every leaf of ``tree`` (a rank's shards) gathered whole over ``axis``
    along the dim its spec gives it; leaves without one as they are."""
    def walk(node, spec):
        if isinstance(node, tp.Mapping):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if axis in spec:
            return axis_all_gather(node, mesh, axis, spec.index(axis))
        return node

    return walk(tree, specs)
