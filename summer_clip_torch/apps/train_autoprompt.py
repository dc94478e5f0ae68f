"""Discrete prompt search: AutoPrompt (HotFlip) and FluentPrompt (SGLD).

Counterpart of ``summer_clip_tpu/apps/train_autoprompt.py``: the CoOp
trainer's setup (stored features, collator, frozen towers) around a
**discrete** prompt:

- ``search.mode=autoprompt``: each step takes the gradient of the loss at the
  current prompt embeddings (one backward through the frozen text tower),
  scores HotFlip candidates, evaluates them on ``search_steps`` fresh batches,
  accepts the best greedily, and keeps the best-loss prompts in a bounded heap
  saved as readable yaml;
- ``search.mode=fluentprompt``: SGLD steps (``sqrt(2 lr beta_t)`` noise from
  the run's seed, geometric beta anneal) on continuous prompt embeddings,
  projected onto the nearest vocabulary embedding after every step.

Each loss is one (C, T) forward of the text tower with the prompt spliced in
(K5 and K6 on the card; the gradient through their ``_ad`` wrappers), plus
the fluency LM when ``loss.fluency`` is set. Batches come in the JAX app's
order: ``np.random.default_rng((random_state, epoch))`` permutes the train
rows and ``(random_state, epoch, 7)`` draws HotFlip's positions.

Run: ``python -m summer_clip_torch.apps.train_autoprompt data.features_key=<key>
search.mode=autoprompt|fluentprompt``.
"""

from __future__ import annotations

import typing as tp
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
import yaml

from summer_clip_torch.apps.train_coop import CoOpTrainer
from summer_clip_torch.core import config as C
from summer_clip_torch.engine.trainer import run_trainer
from summer_clip_torch.methods import prompt_learner as PL
from summer_clip_torch.methods.autoprompt import AutoPromptState, TopPrompter, hotflip_step
from summer_clip_torch.methods.fluentprompt import FluentPromptState, make_langevin_optimizer
from summer_clip_torch.methods.zeroshot import compute_accuracy

__all__ = ["PromptTrainer", "save_step_prompts", "run"]

Batch = tp.Tuple[torch.Tensor, torch.Tensor, np.ndarray]


def save_step_prompts(prompt_items: tp.List[tp.Tuple[tp.List[int], float]],
                      tokenizer, epoch_num: int, step: tp.Union[int, str],
                      checkpoints_dir: Path) -> Path:
    """Readable yaml heap dump (reference train_autoprompt.py:26-39)."""
    step_dir = checkpoints_dir / f"epoch_{epoch_num}" / f"step_{step}"
    step_dir.mkdir(parents=True, exist_ok=True)
    records = [
        {"loss": float(loss), "prompt_ids": [int(i) for i in ids],
         "prompt_tokens": [tokenizer.decoder.get(int(i), "?") for i in ids]}
        for ids, loss in prompt_items
    ]
    (step_dir / "prompts.yaml").write_text(yaml.safe_dump(records, allow_unicode=True))
    return step_dir


class PromptTrainer(CoOpTrainer):
    """Discrete search over the CoOp setup."""

    def setup_model(self):
        super().setup_model()
        init_prompter = C.instantiate(C.to_container(self.cfg.prompt.init_prompter, resolve=True))
        self.init_ids = init_prompter.get_ids(self.tokenizer)
        self.mode = str(self.cfg.search.get("mode", "autoprompt"))
        if self.mode == "autoprompt":
            self.state: tp.Any = AutoPromptState(self.clip_embs_table, self.init_ids)
        else:
            self.state = FluentPromptState(self.clip_embs_table, self.init_ids,
                                           dist_p=float(self.cfg.search.get("dist_p", 2.0)),
                                           device=self.device)
        self.top_prompts = TopPrompter(int(self.cfg.search.get("top_size", 10)))

    def setup_optimizer(self):
        if self.mode == "fluentprompt":
            scfg = self.cfg.search
            steps_per_epoch = max(len(self.train_indices) // int(self.cfg.data.batch_size), 1)
            total = int(self.cfg.training.epochs_num) * steps_per_epoch
            self.tx = make_langevin_optimizer(
                self.state.params, float(self.cfg.training.learning_rate),
                float(scfg.get("beta_start", 1.0)), float(scfg.get("beta_end", 0.0001)),
                total, seed=int(self.cfg.meta.random_state))

    def setup_loss(self):
        self.w_clip = float(self.cfg.loss.get("clip", 1.0))
        self.w_fluency = float(self.cfg.loss.get("fluency", 0.0))

    # -- the loss ------------------------------------------------------------------
    def full_loss(self, prompt_embs: torch.Tensor, prompt_ids, feats: torch.Tensor,
                  labels: torch.Tensor, lm_class_idx: np.ndarray) -> torch.Tensor:
        """CE of the image features against all classes' text features with the
        prompt spliced in, plus the fluency LM's loss of the discrete prompt."""
        tf = F.normalize(self.text_features_for(prompt_embs), dim=-1)
        logits = self.logit_scale * feats @ tf.t()
        loss = self.w_clip * F.cross_entropy(logits, labels)
        if self.w_fluency and self.gpt_model is not None:
            ids, _, mask = self.collator.get_gpt_input(self.class_table, lm_class_idx,
                                                       prompt_ids=torch.as_tensor(prompt_ids))
            ids, mask = ids.to(self.device), mask.to(self.device)
            embeds = PL.splice_prompt_embeds(self.embs_table[ids], prompt_embs)
            lm_out = self.gpt_model(inputs_embeds=embeds)
            loss = loss + self.w_fluency * self.lm_loss.transform(ids, mask, lm_out["logits"])
        return loss

    def _embs(self, prompt_embs) -> torch.Tensor:
        return torch.as_tensor(np.asarray(prompt_embs, np.float32)).to(self.device)

    def loss_value(self, prompt_embs, prompt_ids, batch: Batch) -> float:
        with torch.no_grad():
            return float(self.full_loss(self._embs(prompt_embs), prompt_ids, *batch))

    def loss_and_grad(self, prompt_embs, prompt_ids, batch: Batch
                      ) -> tp.Tuple[float, torch.Tensor]:
        embs = (prompt_embs if isinstance(prompt_embs, torch.Tensor)
                else self._embs(prompt_embs)).detach().requires_grad_()
        loss = self.full_loss(embs, prompt_ids, *batch)
        grad, = torch.autograd.grad(loss, embs)
        return float(loss.detach()), grad

    # -- batch plumbing -------------------------------------------------------------
    def _batch(self, idx: np.ndarray) -> Batch:
        lm_idx = self.text_batcher.get_batch_classes(self.labels[idx])
        dev_idx = torch.from_numpy(idx).to(self.device)
        return (self.image_features[dev_idx],
                torch.from_numpy(self.labels[idx]).to(self.device), lm_idx)

    def _batches_iter(self, epoch_num: int):
        bs = int(self.cfg.data.batch_size)
        rng = np.random.default_rng((int(self.cfg.meta.random_state), epoch_num))
        order = rng.permutation(self.train_indices)
        for s in range(0, (len(order) // bs) * bs, bs):
            yield order[s:s + bs]

    # -- training ---------------------------------------------------------------------
    def train_epoch(self, epoch_num, epoch_info):
        if self.mode == "autoprompt":
            return self._train_epoch_autoprompt(epoch_num, epoch_info)
        return self._train_epoch_fluent(epoch_num, epoch_info)

    def _train_epoch_autoprompt(self, epoch_num, epoch_info):
        scfg = self.cfg.search
        search_steps = int(scfg.get("search_steps", 2))
        num_cands = int(scfg.get("num_cands", 10))
        save_every = int(scfg.get("save_every", 50))
        rng = np.random.default_rng((int(self.cfg.meta.random_state), epoch_num, 7))

        def grad_fn(prompt_embs, batch):
            return self.loss_and_grad(prompt_embs, self.state.prompt_ids, batch)

        batch_ids = list(self._batches_iter(epoch_num))
        step, pos = 0, 0
        while pos + search_steps <= len(batch_ids):
            eval_batches = [self._batch(batch_ids[pos + j]) for j in range(search_steps)]
            pos += search_steps
            step += 1
            info = hotflip_step(self.state, grad_fn, self.loss_value, eval_batches,
                                num_cands=num_cands, rng=rng)
            self.top_prompts.push(self.state.prompt_ids,
                                  min(info["curr_loss"], info["best_cand_loss"])
                                  if info["accepted"] else info["curr_loss"])
            epoch_info.update_values({"loss/train": info["curr_loss"],
                                      "search/accepted": float(info["accepted"])})
            if step % save_every == 0:
                save_step_prompts(self.top_prompts.items(), self.tokenizer, epoch_num, step,
                                  Path(self.cfg.data.get("checkpoints_dir", "checkpoints")))
        return epoch_info

    def _train_epoch_fluent(self, epoch_num, epoch_info):
        embs = self.state.params["prompt_embs"]
        for idx in self._batches_iter(epoch_num):
            loss, grad = self.loss_and_grad(embs, self.state.prompt_ids, self._batch(idx))
            embs.grad = grad
            self.tx.step()
            embs.grad = None
            self.state.project()
            self.top_prompts.push(self.state.prompt_ids, loss)
            epoch_info.update_value("loss/train", loss)
        return epoch_info

    # -- eval / save -------------------------------------------------------------------
    @torch.no_grad()
    def compute_metrics(self, epoch_num, epoch_info):
        embs = (self._embs(self.state.prompt_embs) if self.mode == "autoprompt"
                else self.state.params["prompt_embs"])
        tf = F.normalize(self.text_features_for(embs), dim=-1)
        idx = torch.from_numpy(self.train_indices).to(self.device)
        logits = self.logit_scale * self.image_features[idx] @ tf.t()
        a1, a5 = compute_accuracy(logits, self.labels[self.train_indices])
        epoch_info.update_values({"train/acc1": a1, "train/acc5": a5})

    def save_epoch_model(self, epoch_num):
        step_dir = save_step_prompts(
            self.top_prompts.items(), self.tokenizer, epoch_num, "final",
            Path(self.cfg.data.get("checkpoints_dir", "checkpoints")))
        ids = [int(i) for i in self.state.prompt_ids]
        self.logger.log_info({"type": "prompt", "epoch": epoch_num, "prompt_ids": ids,
                              "prompt_text": self.tokenizer.decode(ids),
                              "checkpoint": str(step_dir)})


@C.main(config_path="../conf", config_name="train_autoprompt")
def run(cfg) -> None:
    run_trainer(PromptTrainer, cfg)


if __name__ == "__main__":
    run()
