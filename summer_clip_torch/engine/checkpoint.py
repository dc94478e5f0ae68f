"""Checkpointing with the trainable-parameters-only split.

Counterpart of ``summer_clip_tpu/engine/checkpoint.py``: a checkpoint directory
holds ``model.ckpt`` (the parameter tree, or the subset a path predicate
keeps, so frozen weights never reach the disk), ``optimizer.ckpt`` and a
``meta.yaml`` with what rebuilds the model (``model_cfg``, and the seed that
initialised it, where the JAX package records its ``init_key``).

Trees are nested dicts of tensors with the JAX package's paths; an optimizer's
state is its ``state_dict()`` (``engine/optim``), restored into the optimizer
built for the run by ``load_checkpoint(..., opt_target=...)``. The tensors
are written with ``torch.save``; the JAX package writes msgpack through
``flax.serialization``, which this package cannot import, so a checkpoint
written there is not readable here yet.
"""

from __future__ import annotations

import typing as tp
from pathlib import Path

import torch
import yaml

from summer_clip_torch.engine.quant import map_tree

__all__ = ["save_pytree", "load_pytree", "filter_tree", "merge_tree",
           "save_checkpoint", "load_checkpoint"]


def _to_cpu(x: tp.Any) -> tp.Any:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def save_pytree(path: tp.Union[str, Path], tree: tp.Any) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(map_tree(lambda _, x: _to_cpu(x), tree), path)


def load_pytree(path: tp.Union[str, Path]) -> tp.Any:
    return torch.load(Path(path), map_location="cpu", weights_only=True)


def filter_tree(tree: tp.Any, keep: tp.Callable[[tp.Tuple[str, ...]], bool]) -> dict:
    """Nested-dict subset of ``tree`` whose paths satisfy ``keep``."""
    out: dict = {}

    def visit(path, leaf):
        if keep(path):
            cur = out
            for n in path[:-1]:
                cur = cur.setdefault(n, {})
            cur[path[-1]] = leaf
        return leaf

    map_tree(visit, tree)
    return out


def merge_tree(base: tp.Any, overlay: dict) -> tp.Any:
    """Return ``base`` with leaves present in ``overlay`` replaced."""
    def rec(b, o):
        if isinstance(o, dict) and isinstance(b, dict):
            out = dict(b)
            for k, v in o.items():
                out[k] = rec(b[k], v) if k in b else v
            return out
        return o
    return rec(base, overlay)


def save_checkpoint(ckpt_dir: tp.Union[str, Path], *, params: tp.Any = None,
                    opt_state: tp.Any = None, meta: tp.Optional[dict] = None,
                    keep: tp.Optional[tp.Callable[[tp.Tuple[str, ...]], bool]] = None,
                    step: tp.Optional[int] = None) -> Path:
    """Save {model.ckpt, optimizer.ckpt, meta.yaml} under ckpt_dir[/step_N]."""
    ckpt_dir = Path(ckpt_dir)
    if step is not None:
        ckpt_dir = ckpt_dir / f"step_{step}"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    if params is not None:
        save_pytree(ckpt_dir / "model.ckpt", filter_tree(params, keep) if keep else params)
    if opt_state is not None:
        save_pytree(ckpt_dir / "optimizer.ckpt", opt_state)
    if meta is not None:
        (ckpt_dir / "meta.yaml").write_text(yaml.safe_dump(meta, sort_keys=False))
    return ckpt_dir


def load_checkpoint(ckpt_dir: tp.Union[str, Path], *, params_target: tp.Any = None,
                    opt_target: tp.Any = None) -> dict:
    """Load whatever a checkpoint directory holds; a trainable-only
    ``model.ckpt`` is merged into ``params_target`` when one is given, and
    ``optimizer.ckpt`` is restored into ``opt_target`` (an optimizer of
    ``engine/optim``, through its ``load_state_dict``) when one is given."""
    ckpt_dir = Path(ckpt_dir)
    out: dict = {}
    model_path = ckpt_dir / "model.ckpt"
    if model_path.exists():
        saved = load_pytree(model_path)
        out["params"] = merge_tree(params_target, saved) if params_target is not None else saved
    opt_path = ckpt_dir / "optimizer.ckpt"
    if opt_path.exists():
        out["opt_state"] = load_pytree(opt_path)
        if opt_target is not None:
            opt_target.load_state_dict(out["opt_state"])
    meta_path = ckpt_dir / "meta.yaml"
    if meta_path.exists():
        out["meta"] = yaml.safe_load(meta_path.read_text())
    return out
