"""ClipGPT pretraining: GPT-2 re-based onto CLIP's vocabulary, trained on a
tokenized corpus.

Counterpart of ``summer_clip_tpu/apps/train_gpt.py``: gradient accumulation
(optax ``MultiSteps``), mid-epoch perplexity evals, trainable-only step
checkpoints, preemption checkpoints and resume. The trainable subset is the
adapters (``clip_gpt_trainable_mask``) or everything but the embedding tables
(``clip_gpt.train_full=true``).

The optimizer keeps the JAX train step's semantics: ``jax.value_and_grad``
differentiates every leaf, and ``clip_by_global_norm`` sits outside the
``multi_transform`` that freezes the rest. So every leaf's gradient is
computed and accumulated, the clipping norm runs over all of them (in
adapters-only runs the whole GPT-2 core and ``clip_emb`` included), and only
the trainable subset moves (``engine.optim.adamw(..., frozen=...)``). Weight
decay follows ``decay_mask``: none on leaves named ``bias`` or ``scale``.

**Layouts** (:class:`TrainLayout`), by the JAX app's rules (its
``setup_mesh``): the ranks are every visible card or ``meta.world_size``
(:func:`visible_world`), one process each (``engine.trainer.run_trainer``);
``training.pp > 1`` excludes ``tp`` and ``fsdp``; otherwise ``dp = world /
tp`` on a ``('data', 'model')`` mesh, and a batch that ``dp`` does not divide
runs on one device (every rank alike; rank 0 writes). ``dp`` alone replicates
the tree; ``training.tp`` cuts the blocks the Megatron way
(``parallel.tp.shard_params_tp``, K4 on a rank's ``n_head / tp`` heads);
``training.fsdp`` keeps a rank's shard of every large leaf
(``parallel.fsdp``, ``training.fsdp_min_elems``; with tp, 2-D shards) and
gathers a block's leaves inside its checkpointed function; ``training.pp``
runs GPipe over ``('data', 'stage')`` with ``training.pp_microbatches``, a
rank holding its stage's blocks (the JAX app runs ``pp`` devices only and
leaves the rest idle; here the other ranks form data rows, the JAX
``pipeline_blocks``' ``data_axis``); ``training.scan_layers`` runs the block
stack as one loop over the stacked tree (``parallel.pp``), with dp. Each rank
takes its rows of the global batch (``shard_batch``); the gradients are
averaged over ``data`` once an update (``TrainLayout.sync``, called by the
optimizer before the clipping), the clipping norm runs over every rank's
shards, the logged loss is the global batch's and eval runs every batch on
every rank (the one-device loss). One all-reduce a micro-step carries the
loss and the preemption flag, so a SIGTERM that reaches one rank stops every
rank at the same micro-step. Checkpoints are written by rank 0 in the
standard layout (slices gathered, qkv columns unpermuted, blocks unstacked),
optimizer state included, and a resume cuts the loaded tree and state for the
run's layout.

On the card each causal self-attention (T <= ``SHORT_MAX_T``) launches K4
``short_attention_packed`` through its differentiable wrapper; with
``training.remat`` a block runs again in the backward, so K4 launches twice
a block and micro-step (a pipeline stage: its blocks at each of ``M + S - 1``
ticks, twice).

Run: ``python -m summer_clip_torch.apps.train_gpt dataset.train.tokens_path=<npy>
dataset.val.tokens_path=<npy>`` (``meta.device=cpu`` for the CPU;
``meta.world_size=2 training.tp=2`` and so on for the layouts).
"""

from __future__ import annotations

import math
import time
import typing as tp
from pathlib import Path

import numpy as np
import torch

from summer_clip_torch.core import config as C
from summer_clip_torch.engine import checkpoint as ckpt
from summer_clip_torch.engine.optim import (adamw, decay_mask, named_state, state_from_named,
                                            warmup_cosine, warmup_linear, with_grad_accum)
from summer_clip_torch.engine.trainer import BaseTrainer, run_trainer, visible_world
from summer_clip_torch.models import gpt2 as gpt2_mod
from summer_clip_torch.models.tokenizer import get_tokenizer
from summer_clip_torch.store import load_array

__all__ = ["lm_loss_fn", "eval_starts", "ClipGPTTrainer", "TrainLayout", "run"]


def lm_loss_fn(logits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Causal-LM shifted cross-entropy with labels == inputs, written as
    ``logsumexp - target_logit`` in f32 so that the normalised (B, T, V)
    log-softmax is never built."""
    lg = logits[:, :-1]
    tgt = lg.gather(-1, ids[:, 1:, None].long())[..., 0].to(torch.float32)
    lse = torch.logsumexp(lg.to(torch.float32), dim=-1)
    return (lse - tgt).mean()


def eval_starts(n_rows: int, batch: int) -> range:
    """The first rows of the eval batches over ``n_rows`` validation rows: the
    JAX app's window arithmetic (full batches only; one batch from row 0 when
    the rows fill exactly one)."""
    n_full = max((n_rows // batch) * batch, batch)
    return range(0, min(n_full, n_rows - batch + 1) or 1, batch)


def _flat(tree, prefix=()) -> tp.Iterator[tp.Tuple[str, tp.Any]]:
    for k, v in tree.items():
        if isinstance(v, tp.Mapping):
            yield from _flat(v, prefix + (str(k),))
        else:
            yield ".".join(prefix + (str(k),)), v


def _nest(flat: tp.Mapping[str, tp.Any]) -> dict:
    out: dict = {}
    for name, v in flat.items():
        cur = out
        keys = name.split(".")
        for k in keys[:-1]:
            cur = cur.setdefault(k, {})
        cur[keys[-1]] = v
    return out


def _block_index(name: str) -> tp.Optional[int]:
    parts = name.split(".")
    if len(parts) > 2 and parts[0] == "core" and parts[1].startswith("h_"):
        return int(parts[1][2:])
    return None


class TrainLayout:
    """How this rank holds the ClipGPT tree and runs its forward, and how its
    gradients, norm and checkpoints combine over the mesh (``mesh=None``: one
    device). Leaves keep their standard names; ``spec`` gives, per name, the
    mesh axis that cuts each dim (``parallel.tp`` / ``parallel.fsdp``), and a
    pipeline stage holds the blocks of its stage only."""

    def __init__(self, mesh=None, *, fsdp: bool = False, fsdp_min_elems: int = 2 ** 14,
                 scan: bool = False, n_microbatches: int = 1):
        self.mesh = mesh
        self.tp = mesh.size("model") if mesh else 1
        self.dp = mesh.size("data") if mesh else 1
        self.pp = mesh.size("stage") if mesh else 1
        self.world = math.prod(mesh.shape.values()) if mesh else 1
        self.fsdp, self.fsdp_min_elems = fsdp, fsdp_min_elems
        self.scan, self.n_microbatches = scan, n_microbatches
        self.spec: tp.Dict[str, tuple] = {}
        self.names: tp.Dict[int, str] = {}
        self.last_sync_s = 0.0

    @property
    def cuts(self) -> bool:
        """Whether a rank's leaves differ from the one-device tree's."""
        return self.tp > 1 or self.fsdp or self.pp > 1

    @property
    def describe(self) -> str:
        if self.mesh is None:
            return "one device"
        kind = ("pipeline" if self.pp > 1 else "fsdp" if self.fsdp else "tp" if self.tp > 1
                else "dp")
        return (f"{kind}{' + scan_layers' if self.scan else ''} over "
                f"{' x '.join(f'{a}={n}' for a, n in self.mesh.shape.items())}")

    # -- the rank's leaves ----------------------------------------------------
    def localize(self, model) -> None:
        """Cut ``model``'s whole leaves (every rank draws the same tree) into
        this rank's, in place."""
        from summer_clip_torch.parallel import fsdp as F
        from summer_clip_torch.parallel import tp as T

        full = model.tree()
        if self.fsdp:
            specs = F.fsdp_specs(full, self.dp, self.tp > 1, self.fsdp_min_elems)
            self.spec = dict(_flat(specs))
            T.install_leaves(model, F.shard_params_fsdp(full, self.mesh, self.tp > 1,
                                                        self.fsdp_min_elems))
        elif self.tp > 1:
            self.spec = {n: T.gpt2_tp_spec(n.split("."), leaf) for n, leaf in _flat(full)}
            T.install_leaves(model, T.shard_params_tp(full, self.mesh))
        if self.pp > 1:
            lps = model.config.n_layer // self.pp
            stage = self.mesh.coords["stage"]
            for i in range(model.config.n_layer):
                if i // lps != stage:
                    delattr(model.core, f"h_{i}")
        model.requires_grad_(True)
        self.names = {id(p): n for n, p in model.named_parameters()}

    def _qkv(self, name: str) -> bool:
        return self.tp > 1 and ".c_attn." in f".{name}" and name.endswith(".kernel")

    def shard_axes(self, name: str) -> tp.Tuple[str, ...]:
        """The mesh axes over which the ranks hold parts of the leaf."""
        axes = tuple(a for a in self.spec.get(name, ()) if a is not None)
        return axes + (("stage",) if self.pp > 1 and _block_index(name) is not None else ())

    def sync_axes(self, name: str) -> tp.Tuple[str, ...]:
        """The axes over which the leaf's gradient is summed at an update: data
        (unless FSDP shards it, whose gather summed it in the backward), and
        model for a column bias that a TP rank uses in part."""
        from summer_clip_torch.parallel.tp import tp_partial_leaf

        axes = ("data",) if self.dp > 1 and "data" not in self.spec.get(name, ()) else ()
        if self.tp > 1 and tp_partial_leaf(name.split(".")):
            axes += ("model",)
        return axes

    def slice_named(self, full: tp.Mapping[str, torch.Tensor]) -> tp.Dict[str, torch.Tensor]:
        """This rank's part of each whole leaf of ``full`` it holds."""
        from summer_clip_torch.parallel.tp import take_spec
        from summer_clip_torch.parallel.tp_int8 import permute_qkv_columns

        out = {}
        for name in self.names.values():
            if name not in full:
                continue
            t = full[name]
            if self._qkv(name):
                t = permute_qkv_columns(t, t.shape[0], self.tp)
            out[name] = take_spec(t, self.spec.get(name, ()), self.mesh) if self.mesh else t
        return out

    def gather_named(self, local: tp.Mapping[str, torch.Tensor]) -> tp.Dict[str, torch.Tensor]:
        """The whole leaves of ``local`` (this rank's parts, in the same order
        on every rank), on every rank: a collective."""
        from summer_clip_torch.parallel.mesh import all_gather
        from summer_clip_torch.parallel.tp_int8 import _qkv_perm

        if not self.cuts:
            return dict(local)
        out = {}
        lps = None
        for name, t in local.items():
            block = _block_index(name)
            if self.pp > 1 and block is not None:
                lps = lps or len({_block_index(n) for n in self.names.values()} - {None})
                j, rest = block % lps, name.split(".", 2)[2]
                for s, part in enumerate(all_gather(t, self.mesh, "stage")):
                    out[f"core.h_{s * lps + j}.{rest}"] = part
                continue
            for dim, axis in enumerate(self.spec.get(name, ())):
                if axis is not None and self.mesh.size(axis) > 1:
                    t = torch.cat(all_gather(t, self.mesh, axis), dim)
            if self._qkv(name):
                inverse = torch.from_numpy(np.argsort(_qkv_perm(t.shape[0], self.tp)))
                t = t[..., inverse.to(t.device)]
            out[name] = t
        return out

    def gather_state(self, named: dict) -> dict:
        """:func:`engine.optim.named_state` of this rank made whole."""
        moments = named["moments"]
        whole = {k: self.gather_named({n: m[k] for n, m in moments.items()})
                 for k in ("exp_avg", "exp_avg_sq")}
        step = next(iter(moments.values()))["step"] if moments else None   # the update count
        acc = None if named["acc"] is None else self.gather_named(named["acc"])
        return {**named, "acc": acc, "moments": {
            n: {"step": step.clone(), "exp_avg": whole["exp_avg"][n],
                "exp_avg_sq": whole["exp_avg_sq"][n]} for n in whole["exp_avg"]}}

    def slice_state(self, named: dict) -> dict:
        """A whole :func:`engine.optim.named_state` cut to this rank's leaves."""
        moments = named["moments"]
        parts = {k: self.slice_named({n: m[k] for n, m in moments.items()})
                 for k in ("exp_avg", "exp_avg_sq")}
        return {**named, "acc": None if named["acc"] is None else self.slice_named(named["acc"]),
                "moments": {n: {"step": moments[n]["step"], "exp_avg": parts["exp_avg"][n],
                                "exp_avg_sq": parts["exp_avg_sq"][n]} for n in parts["exp_avg"]}}

    # -- the forward ------------------------------------------------------------
    def logits(self, model, ids: torch.Tensor) -> torch.Tensor:
        """The LM logits of this rank's ``ids`` in the layout's forward."""
        from summer_clip_torch.parallel import pp as P
        from summer_clip_torch.parallel import tp as T

        if self.pp > 1:
            rest, stacked = P.stack_block_params(T.param_tree(model), 1)
            return P.pp_clip_gpt_forward(model, rest, stacked, ids, self.mesh,
                                         n_microbatches=self.n_microbatches, data_axis="data")
        if self.scan:
            rest, stacked = P.stack_block_params(T.param_tree(model), 1)
            return P.scan_clip_gpt_forward(model, rest, stacked, ids, remat=model.core.remat)
        if self.fsdp:
            return self._fsdp_logits(model, ids)
        if self.tp > 1:
            return T.tp_clip_gpt_forward(model, ids, self.mesh)
        return model(ids)["logits"]

    def _fsdp_logits(self, model, ids):
        """The stem and head's leaves gathered once; each block's inside its
        checkpointed function (``parallel.tp.block_stack``)."""
        import functools

        from summer_clip_torch.parallel import fsdp as F
        from summer_clip_torch.parallel import pp as P
        from summer_clip_torch.parallel import tp as T

        specs = _nest(self.spec)
        params = T.param_tree(model)
        rest = {k: v for k, v in params.items() if k != "core"}
        rest["core"] = {k: v for k, v in params["core"].items() if not k.startswith("h_")}
        rest = F.fsdp_gather(rest, specs, self.mesh)
        block_fn = functools.partial(_fsdp_block, specs["core"]["h_0"], self.mesh,
                                     model.config.n_head, model.dtype)
        x = T.block_stack(model, P.clip_gpt_stem(model, rest, ids), block_fn)
        return P.clip_gpt_head(model, rest, x)

    # -- the optimizer's hooks (``engine.optim.Optimizer(grad_layout=)``) ------
    def sync(self, params: tp.Sequence[torch.Tensor]) -> None:
        """The update's gradients summed over their :meth:`sync_axes` (f32
        buckets of up to 2^26 values), then divided by ``dp``: the mean of
        the ranks' gradients of their rows' mean loss."""
        t0 = time.perf_counter()
        by_axes: tp.Dict[tuple, tp.List[torch.Tensor]] = {}
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            by_axes.setdefault(self.sync_axes(self.names[id(p)]), []).append(p.grad)
        for axes, grads in sorted(by_axes.items()):
            for axis in axes:
                _all_reduce_buckets(grads, self.mesh.groups[axis])
        if self.dp > 1:
            for p in params:
                p.grad.div_(self.dp)
        if params and params[0].device.type == "cuda":
            torch.cuda.synchronize(params[0].device)
        self.last_sync_s = time.perf_counter() - t0

    def squared_norm(self, pairs: tp.Sequence[tp.Tuple[torch.Tensor, torch.Tensor]]) -> float:
        """The square of the global norm over every rank's gradients: each
        rank's sum of squares, a leaf held whole by ``r`` ranks counted
        ``1 / r`` a rank, summed over the mesh (f64)."""
        import torch.distributed as dist

        total = None
        for p, g in pairs:
            axes = self.shard_axes(self.names[id(p)])
            held_by = self.world // math.prod(self.mesh.size(a) for a in axes)
            part = (g.float() ** 2).sum().double() / held_by
            total = part if total is None else total + part
        if total is None:
            total = torch.zeros((), dtype=torch.float64, device=self.mesh.device)
        dist.all_reduce(total)
        return float(total)


def _fsdp_block(specs, mesh, num_heads, dtype, p, x):
    from summer_clip_torch.parallel.fsdp import fsdp_gather
    from summer_clip_torch.parallel.tp import tp_block_forward

    return tp_block_forward(fsdp_gather(p, specs, mesh), x, num_heads=num_heads, dtype=dtype,
                            mesh=mesh if mesh.size("model") > 1 else None)


def _all_reduce_buckets(grads: tp.Sequence[torch.Tensor], group, bucket: int = 2 ** 26) -> None:
    """Sum each tensor over ``group`` in place, several in one flat f32 buffer
    of up to ``bucket`` values."""
    import torch.distributed as dist

    i = 0
    while i < len(grads):
        chunk, n = [], 0
        while i < len(grads) and (not chunk or n + grads[i].numel() <= bucket):
            chunk.append(grads[i])
            n += grads[i].numel()
            i += 1
        flat = torch.cat([g.reshape(-1).to(torch.float32) for g in chunk])
        dist.all_reduce(flat, group=group)
        off = 0
        for g in chunk:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


class ClipGPTTrainer(BaseTrainer):
    @classmethod
    def world_size(cls, cfg) -> int:
        """Every visible card, or ``meta.world_size``."""
        return visible_world(cfg)

    def setup_mesh(self):
        """The JAX app's ``setup_mesh`` over the process group's ranks."""
        import torch.distributed as dist

        from summer_clip_torch.parallel import create_mesh

        super().setup_mesh()
        n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        tcfg = self.cfg.training
        bs = int(self.cfg.data_loader.train.batch_size)
        tp_size, pp = int(tcfg.get("tp", 1)), int(tcfg.get("pp", 1))
        fsdp, scan = bool(tcfg.get("fsdp", False)), bool(tcfg.get("scan_layers", False))
        n_micro = int(tcfg.get("pp_microbatches", 2))
        from summer_clip_torch.parallel.fsdp import FSDP_MIN_ELEMS

        kw = dict(fsdp=fsdp, fsdp_min_elems=int(tcfg.get("fsdp_min_elems") or FSDP_MIN_ELEMS),
                  scan=scan, n_microbatches=n_micro)
        if scan and (tp_size > 1 or fsdp):
            raise ValueError("training.scan_layers composes with DP only (not tp / fsdp)")
        if pp > 1:
            if tp_size > 1 or fsdp:
                raise ValueError("training.pp excludes training.tp and training.fsdp")
            if n % pp:
                raise ValueError(f"pp={pp} does not divide {n} ranks")
            dp = n // pp
            if bs % dp or (bs // dp) % n_micro:
                raise ValueError(f"batch size {bs} does not split over {dp} data rows of "
                                 f"{n_micro} microbatches")
            self.mesh = create_mesh(axes={"data": dp, "stage": pp})
            self.layout = TrainLayout(self.mesh, **{**kw, "scan": False})
            self.logger.log_info(f"mesh: pipeline over {pp} stages (GPipe, {n_micro} "
                                 f"microbatches) x {dp} data rows")
            return
        if n % tp_size:
            raise ValueError(f"tp={tp_size} does not divide {n} ranks")
        dp = n // tp_size
        if n > 1 and bs % dp == 0:
            self.mesh = create_mesh(data=dp, model=tp_size)
            if tp_size > 1:
                self.logger.log_info(f"mesh: data={dp} x model={tp_size} (Megatron TP)")
        else:
            if n > 1:
                self.logger.log_info(f"WARNING: batch size {bs} not divisible by {dp} data "
                                     f"shards — running single-device")
            self.mesh = None
        self.layout = TrainLayout(self.mesh, **kw)

    def setup_dataset(self):
        self.tokenizer = get_tokenizer()
        dcfg = self.cfg.dataset
        self.train_tokens = np.asarray(load_array(dcfg.train.tokens_path), np.int32)
        if dcfg.train.get("subpart"):
            rng = np.random.default_rng(int(self.cfg.meta.random_state))
            n = int(float(dcfg.train.subpart) * len(self.train_tokens))
            self.train_tokens = self.train_tokens[rng.permutation(len(self.train_tokens))[:n]]
        self.val_tokens = (np.asarray(load_array(dcfg.val.tokens_path), np.int32)
                           if dcfg.get("val") and dcfg.val.get("tokens_path") else None)
        self.logger.log_info(
            f"train chunks: {len(self.train_tokens)}, "
            f"val chunks: {len(self.val_tokens) if self.val_tokens is not None else 0}")

    def _build(self, device) -> gpt2_mod.ClipGPT:
        tcfg, mcfg = self.cfg.training, self.cfg.clip_gpt
        dtype = torch.bfloat16 if bool(tcfg.get("bf16", False)) else torch.float32
        return gpt2_mod.ClipGPT(
            gpt2_mod.GPT2_CONFIGS[str(mcfg.gpt_config)],
            clip_vocab_size=self.tokenizer.vocab_size, clip_emb_dim=int(mcfg.clip_emb_dim),
            emb_hid_dim=int(mcfg.adapters.emb_hid_dim), head_hid_dim=mcfg.adapters.get("head_hid_dim"),
            dtype=dtype, device=device, remat=bool(tcfg.get("remat", False)),
            remat_policy=tcfg.get("remat_policy"))

    def setup_model(self):
        mcfg = self.cfg.clip_gpt
        cfg = gpt2_mod.GPT2_CONFIGS[str(mcfg.gpt_config)]
        if self.layout.tp > 1:
            from summer_clip_torch.parallel import check_tp_divisibility

            check_tp_divisibility(cfg.n_embd, cfg.n_head, self.layout.tp)
        if self.layout.pp > 1:
            from summer_clip_torch.parallel import check_pp_divisibility

            check_pp_divisibility(cfg.n_layer, self.layout.pp)
        self.model = self._build(self.device)
        # checkpoints hold only the trainable subset, so the frozen leaves must
        # come back from the seed that drew them: it rides the checkpoint meta
        self._init_seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.generator))
        self.model.init_weights(torch.Generator().manual_seed(self._init_seed))
        self.trainable_mask_fn = (gpt2_mod.clip_gpt_full_trainable_mask
                                  if bool(mcfg.get("train_full", False))
                                  else gpt2_mod.clip_gpt_trainable_mask)
        if mcfg.get("clip_checkpoint_path") and Path(mcfg.clip_checkpoint_path).exists():
            # the CLIP token table of a converted CLIP checkpoint
            from summer_clip_torch.models.clip.convert import load_clip

            clip_model, _ = load_clip(mcfg.clip_checkpoint_path, device="cpu")
            with torch.no_grad():
                self.model.clip_emb.copy_(clip_model.token_embedding.weight.float())
        # every leaf is differentiated, as jax.value_and_grad differentiates the tree
        self.layout.localize(self.model)
        self.logger.log_info(
            f"layout: {self.layout.describe}; this rank holds "
            f"{sum(p.numel() * p.element_size() for p in self.model.parameters())} parameter "
            f"bytes")

    def is_trainable(self, name: str) -> bool:
        return bool(self.trainable_mask_fn(tuple(name.split("."))))

    def _make_tx(self, named: tp.Mapping[str, torch.Tensor], grad_layout=None):
        ocfg, scfg, tcfg = self.cfg.optim, self.cfg.scheduler, self.cfg.training
        accum = int(tcfg.get("grad_accum_steps", 1))
        steps_per_epoch = max(len(self.train_tokens) // int(self.cfg.data_loader.train.batch_size), 1)
        total = int(tcfg.epochs_num) * steps_per_epoch // max(accum, 1)
        warmup = int(total * float(scfg.get("warmup_part", 0.0)))
        sched_fn = warmup_cosine if str(scfg.get("name", "cosine")) == "cosine" else warmup_linear
        schedule = sched_fn(float(ocfg.adamw_kwargs.lr), warmup, total)
        trainable = {n: p for n, p in named.items() if self.is_trainable(n)}
        frozen = [p for n, p in named.items() if not self.is_trainable(n)]
        kw = {k: float(v) for k, v in ocfg.adamw_kwargs.items() if k != "lr"}
        clip_norm = float(tcfg.get("clip_grad_norm", 0) or 0)
        base = adamw(trainable, schedule, weight_decay=float(ocfg.weight_decay),
                     mask=decay_mask(trainable), grad_clip_norm=clip_norm or None,
                     frozen=frozen, grad_layout=grad_layout, **kw)
        return with_grad_accum(base, accum)

    def setup_optimizer(self):
        named = dict(self.model.named_parameters())   # names: the tree's paths, dot-joined
        self.tx = self._make_tx(named, self.layout if self.mesh is not None else None)

    def _whole_optimizer(self):
        """The one-device optimizer of this run on meta tensors, and its
        leaves' names by id: the standard layout of an optimizer state."""
        named = dict(self._build("meta").named_parameters())
        return self._make_tx(named), {id(p): n for n, p in named.items()}, named

    def setup(self):
        super().setup()
        self.setup_pretrained()

    def setup_pretrained(self):
        """``pretrained.model``: a step checkpoint's leaves (the standard
        layout) cut for this rank and copied into the model in place (the
        optimizer keeps its parameters), over those of ``pretrained.base``
        (the whole tree, which a JAX step checkpoint needs:
        ``engine.checkpoint.trainable_over_base``); ``pretrained.optimizer``:
        its optimizer state restored too (an optax state converted by
        ``engine.checkpoint.optax_state_dict``, a stacked one unstacked
        first), cut for this rank."""
        pcfg = self.cfg.get("pretrained") or {}
        model_path = pcfg.get("model") if hasattr(pcfg, "get") else None
        if not (model_path and Path(model_path).exists()):
            return
        named = dict(self.model.named_parameters())
        loaded = ckpt.load_checkpoint(Path(model_path))
        whole_tx, whole_names, whole_named = self._whole_optimizer()
        tree = ckpt.trainable_over_base(loaded, pcfg.get("base"), list(whole_named), model_path)
        local = self.layout.slice_named(dict(_flat(tree)))
        with torch.no_grad():
            for name, value in local.items():
                named[name].copy_(value)
        state = loaded.get("opt_state")
        if bool(pcfg.get("optimizer")) and state is not None:
            if not ckpt.is_port_state(state):
                state = ckpt.optax_state_dict(state, whole_tx, whole_named)
            if self.layout.cuts:
                state = state_from_named(self.layout.slice_state(
                    named_state(state, whole_tx, whole_names)), self.tx, self.layout.names)
            self.tx.load_state_dict(state)
        self.logger.log_info(f"Resumed from {model_path}")

    def logits(self, ids: torch.Tensor) -> torch.Tensor:
        return self.layout.logits(self.model, ids)

    def loss(self, ids: torch.Tensor) -> torch.Tensor:
        return lm_loss_fn(self.logits(ids), ids)

    def train_step(self, ids: torch.Tensor) -> float:
        """One micro-step on the global batch ``ids`` (this rank takes its
        rows): every leaf's gradient into the accumulator, and an update on
        every ``grad_accum_steps``-th call. Returns the global batch's loss."""
        if self.mesh is not None:
            from summer_clip_torch.parallel import shard_batch

            ids = shard_batch(ids, self.mesh)
        loss = self.loss(ids)
        loss.backward()
        self.tx.step()
        self.tx.zero_grad()
        # the data rows' mean loss (every model / stage rank holds its row's),
        # and the ranks' agreed preemption flag
        return self.agree(float(loss.detach()))[0] / self.layout.world

    @torch.no_grad()
    def evaluate(self) -> tp.Tuple[float, float]:
        assert self.val_tokens is not None
        bs = int(self.cfg.data_loader.val.batch_size)
        losses = []
        for s in eval_starts(len(self.val_tokens), bs):
            ids = torch.from_numpy(np.array(self.val_tokens[s:s + bs])).to(self.device)
            losses.append(float(self.loss(ids)))
        loss = float(np.mean(losses)) if losses else float("nan")
        return loss, float(np.exp(loss))

    def save_step_model(self, epoch_num: int, step: tp.Union[int, str],
                        with_optimizer: bool = False) -> tp.Optional[Path]:
        """Every rank calls this (the gathers are collectives); rank 0 writes
        the standard layout."""
        from summer_clip_torch.parallel.mesh import leads

        step_dir = (Path(str(self.cfg.training.checkpoints_dir)) / f"epoch_{epoch_num}"
                    / f"step_{step}")
        opt_state = self.tx.state_dict() if with_optimizer else None
        if self.layout.cuts:
            keep = {n: p.detach() for n, p in self.model.named_parameters()
                    if self.trainable_mask_fn(tuple(n.split(".")))}
            params = _nest(self.layout.gather_named(keep))
            if opt_state is not None:
                whole = self.layout.gather_state(named_state(opt_state, self.tx,
                                                             self.layout.names))
                whole_tx, whole_names, _ = self._whole_optimizer()
                opt_state = state_from_named(whole, whole_tx, whole_names)
        else:
            params = self.model.tree()
        if not leads():
            return None
        return ckpt.save_checkpoint(
            step_dir, params=params, opt_state=opt_state, keep=self.trainable_mask_fn,
            meta={"model_cfg": C.to_container(self.cfg.clip_gpt, resolve=True),
                  "init_seed": self._init_seed})

    def train_epoch(self, epoch_num, epoch_info):
        tcfg = self.cfg.training
        bs = int(self.cfg.data_loader.train.batch_size)
        rng = np.random.default_rng((int(self.cfg.meta.random_state), epoch_num))
        order = rng.permutation(len(self.train_tokens))
        steps_total = len(order) // bs
        evals = max(int(tcfg.get("evals_per_epoch", 1)), 1)
        eval_steps = set(range(steps_total, 0, -max(steps_total // evals, 1))[:evals]) \
            if steps_total else set()

        for step in range(1, steps_total + 1):
            idx = order[(step - 1) * bs: step * bs]
            loss = self.train_step(torch.from_numpy(self.train_tokens[idx]).to(self.device))
            epoch_info.update_value("loss/train", loss)

            if step % int(tcfg.get("info_steps", 100)) == 0:
                self.logger.log_info_wandb({
                    "samples": step * bs, "steps": step, "loss/train": loss})
            if step in eval_steps:
                if self.val_tokens is not None:
                    eval_loss, perplexity = self.evaluate()
                    self.logger.log_info({"type": "gpt_eval", "loss/eval": eval_loss,
                                          "metrics/perplexity": perplexity, "step": step})
                    epoch_info.update_values({"loss/eval": eval_loss,
                                              "metrics/perplexity": perplexity})
                self.save_step_model(epoch_num, step, with_optimizer=(step == max(eval_steps)))
            if self.preempted():
                # checkpoint with the optimizer mid-epoch, so that pretrained.model /
                # pretrained.optimizer resume at exactly this step
                self.save_step_model(epoch_num, f"{step}_preempt", with_optimizer=True)
                self.logger.log_info({"type": "preempted", "epoch": epoch_num, "step": step})
                break
        return epoch_info


@C.main(config_path="../conf", config_name="train_gpt")
def run(cfg) -> None:
    return run_trainer(ClipGPTTrainer, cfg)


if __name__ == "__main__":
    run()
