"""Tensor-parallel slicing rules for the GPT family (Megatron layout).

Counterpart of ``summer_clip_tpu/parallel/tp.py``. The mesh's ``model`` axis
splits the transformer's matrices the Megatron way:

- ``c_attn`` / ``mlp_c_fc`` kernels: column-parallel ``(None, "model")``
  (heads and hidden units split over the ranks),
- attention ``c_proj`` / ``mlp_c_proj`` kernels: row-parallel
  ``("model", None)`` (the product's partial sums are all-reduced),
- embeddings, LayerNorms, biases and adapters: replicated ``()``.

A spec is the tuple the JAX ``PartitionSpec`` holds. The JAX package's bf16
decode places the Flax tree by these specs and lets GSPMD insert the
collectives; the port has no GSPMD, so :func:`shard_decode_tp` gives the rank
the explicit layout of ``parallel/tp_int8`` (column-parallel biases sliced,
the fused qkv columns permuted), which serves float and int8 trees alike.
``shard_params_tp`` (the training layout) is not ported here.
"""

from __future__ import annotations

import typing as tp

__all__ = ["gpt2_tp_spec", "check_tp_divisibility", "shard_decode_tp"]

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
