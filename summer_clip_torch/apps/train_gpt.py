"""ClipGPT pretraining: GPT-2 re-based onto CLIP's vocabulary, trained on a
tokenized corpus.

Counterpart of ``summer_clip_tpu/apps/train_gpt.py`` on one device: gradient
accumulation (optax ``MultiSteps``), mid-epoch perplexity evals, trainable-only
step checkpoints, preemption checkpoints and resume. The trainable subset is
the adapters (``clip_gpt_trainable_mask``) or everything but the embedding
tables (``clip_gpt.train_full=true``).

The optimizer keeps the JAX train step's semantics: ``jax.value_and_grad``
differentiates every leaf, and ``clip_by_global_norm`` sits outside the
``multi_transform`` that freezes the rest. So every leaf's gradient is
computed and accumulated, the clipping norm runs over all of them (in
adapters-only runs the whole GPT-2 core and ``clip_emb`` included), and only
the trainable subset moves (``engine.optim.adamw(..., frozen=...)``). Weight
decay follows ``decay_mask``: none on leaves named ``bias`` or ``scale``.

On the card each causal self-attention (T <= ``SHORT_MAX_T``) launches K4
``short_attention_packed`` through its differentiable wrapper; with
``training.remat`` a block runs again in the backward, so K4 launches twice
a block and micro-step. ``training.tp > 1``, ``pp > 1``, ``fsdp`` and
``scan_layers`` raise ``NotImplementedError``: the JAX package's mesh,
pipeline, sharded and stacked layouts wait for ROADMAP Queue 1 item 8.

Run: ``python -m summer_clip_torch.apps.train_gpt dataset.train.tokens_path=<npy>
dataset.val.tokens_path=<npy>`` (``meta.device=cpu`` for the CPU).
"""

from __future__ import annotations

import typing as tp
from pathlib import Path

import numpy as np
import torch

from summer_clip_torch.core import config as C
from summer_clip_torch.engine import checkpoint as ckpt
from summer_clip_torch.engine.optim import (adamw, decay_mask, warmup_cosine, warmup_linear,
                                            with_grad_accum)
from summer_clip_torch.engine.quant import map_tree
from summer_clip_torch.engine.trainer import BaseTrainer, run_trainer
from summer_clip_torch.models import gpt2 as gpt2_mod
from summer_clip_torch.models.tokenizer import get_tokenizer
from summer_clip_torch.store import load_array

__all__ = ["lm_loss_fn", "eval_starts", "ClipGPTTrainer", "run"]


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


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"train_gpt: {what} is not ported (ROADMAP Queue 1 item 8); "
                               f"the port trains on one device")


class ClipGPTTrainer(BaseTrainer):
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

    def setup_model(self):
        tcfg = self.cfg.training
        if int(tcfg.get("tp", 1)) > 1:
            raise _unported("training.tp > 1 (tensor parallelism)")
        if int(tcfg.get("pp", 1)) > 1:
            raise _unported("training.pp > 1 (pipeline stages)")
        if bool(tcfg.get("fsdp", False)):
            raise _unported("training.fsdp (sharded parameters)")
        if bool(tcfg.get("scan_layers", False)):
            raise _unported("training.scan_layers (the stacked block layout)")
        mcfg = self.cfg.clip_gpt
        dtype = torch.bfloat16 if bool(tcfg.get("bf16", False)) else torch.float32
        self.model = gpt2_mod.ClipGPT(
            gpt2_mod.GPT2_CONFIGS[str(mcfg.gpt_config)],
            clip_vocab_size=self.tokenizer.vocab_size, clip_emb_dim=int(mcfg.clip_emb_dim),
            emb_hid_dim=int(mcfg.adapters.emb_hid_dim), head_hid_dim=mcfg.adapters.get("head_hid_dim"),
            dtype=dtype, device=self.device, remat=bool(tcfg.get("remat", False)),
            remat_policy=tcfg.get("remat_policy"))
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
        self.model.requires_grad_(True)

    def is_trainable(self, name: str) -> bool:
        return bool(self.trainable_mask_fn(tuple(name.split("."))))

    def setup_optimizer(self):
        ocfg, scfg, tcfg = self.cfg.optim, self.cfg.scheduler, self.cfg.training
        accum = int(tcfg.get("grad_accum_steps", 1))
        steps_per_epoch = max(len(self.train_tokens) // int(self.cfg.data_loader.train.batch_size), 1)
        total = int(tcfg.epochs_num) * steps_per_epoch // max(accum, 1)
        warmup = int(total * float(scfg.get("warmup_part", 0.0)))
        sched_fn = warmup_cosine if str(scfg.get("name", "cosine")) == "cosine" else warmup_linear
        schedule = sched_fn(float(ocfg.adamw_kwargs.lr), warmup, total)
        named = dict(self.model.named_parameters())   # names: the tree's paths, dot-joined
        trainable = {n: p for n, p in named.items() if self.is_trainable(n)}
        frozen = [p for n, p in named.items() if not self.is_trainable(n)]
        kw = {k: float(v) for k, v in ocfg.adamw_kwargs.items() if k != "lr"}
        clip_norm = float(tcfg.get("clip_grad_norm", 0) or 0)
        base = adamw(trainable, schedule, weight_decay=float(ocfg.weight_decay),
                     mask=decay_mask(trainable), grad_clip_norm=clip_norm or None,
                     frozen=frozen, **kw)
        self.tx = with_grad_accum(base, accum)

    def setup(self):
        super().setup()
        self.setup_pretrained()

    def setup_pretrained(self):
        """``pretrained.model``: a step checkpoint's leaves copied into the
        model in place (the optimizer keeps its parameters);
        ``pretrained.optimizer``: its optimizer state restored too."""
        pcfg = self.cfg.get("pretrained") or {}
        model_path = pcfg.get("model") if hasattr(pcfg, "get") else None
        if not (model_path and Path(model_path).exists()):
            return
        loaded = ckpt.load_checkpoint(
            Path(model_path), opt_target=self.tx if bool(pcfg.get("optimizer")) else None)
        named = dict(self.model.named_parameters())
        with torch.no_grad():
            map_tree(lambda path, value: named[".".join(path)].copy_(value),
                     loaded.get("params") or {})
        self.logger.log_info(f"Resumed from {model_path}")

    def loss(self, ids: torch.Tensor) -> torch.Tensor:
        return lm_loss_fn(self.model(ids)["logits"], ids)

    def train_step(self, ids: torch.Tensor) -> float:
        """One micro-step: every leaf's gradient into the accumulator, and an
        update on every ``grad_accum_steps``-th call."""
        loss = self.loss(ids)
        loss.backward()
        self.tx.step()
        self.tx.zero_grad()
        return float(loss.detach())

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
                        with_optimizer: bool = False) -> Path:
        step_dir = (Path(str(self.cfg.training.checkpoints_dir)) / f"epoch_{epoch_num}"
                    / f"step_{step}")
        return ckpt.save_checkpoint(
            step_dir, params=self.model.tree(),
            opt_state=self.tx.state_dict() if with_optimizer else None,
            keep=self.trainable_mask_fn,
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
    run_trainer(ClipGPTTrainer, cfg)


if __name__ == "__main__":
    run()
