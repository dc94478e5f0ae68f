"""CoOp-family prompt training: soft or discrete prompts through frozen CLIP.

Counterpart of ``summer_clip_tpu/apps/train_coop.py``: optimize a prompt
(CoOp continuous, VQ straight-through, Gumbel relaxations) against

    loss = w_clip * CE(image-text logits) + w_fluency * LM + w_entropy * H

where the gradient flows through the frozen text tower into the spliced
prompt embeddings and, for fluency, through a ClipGPT. Each step recomputes
the text features of all classes with the prompt spliced in (one (C, T)
forward of the text tower: K5 and K6 on the card, reached through their
``_ad`` wrappers, whose backward recomputes the plain blocks); the ClipGPT
forward runs its attention through K4 (``short_attention_packed_ad``). Image
features are stored (N, D) arrays from the feature store. The Gumbel
temperature comes from the host-side scheduler. Optimizer: AdamW on a warmup
cosine schedule, optional global-norm clipping and gradient accumulation
(``engine/optim``, optax's semantics).

Run: ``python -m summer_clip_torch.apps.train_coop data.features_key=<key>``
(``meta.device=cpu`` forces the CPU; ``+gpt.checkpoint_dir=<dir>`` loads the
fluency LM from a ClipGPT checkpoint of the port; ``prompt_model=gumbel_v3a1``
with a ``gpt`` config trains an autoregressive proposer on that LM, an adapter
head or LoRA factors, ``prompt_model.head.kind=lora``).
"""

from __future__ import annotations

import typing as tp
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
import yaml

from summer_clip_torch.apps.common import create_clip_session
from summer_clip_torch.apps.features_io import resolve_array, resolve_features
from summer_clip_torch.apps.gen_gpt import build_clip_gpt, load_pretrained_clip_gpt
from summer_clip_torch.apps.train_adapter import balanced_indices
from summer_clip_torch.core import config as C
from summer_clip_torch.engine import checkpoint as ckpt
from summer_clip_torch.engine.optim import adamw, warmup_cosine, with_grad_accum
from summer_clip_torch.engine.trainer import BaseTrainer, run_trainer
from summer_clip_torch.methods import prompt_learner as PL
from summer_clip_torch.methods.zeroshot import compute_accuracy
from summer_clip_torch.models.tokenizer import get_tokenizer
from summer_clip_torch.store import FeatureStore

__all__ = ["CoOpTrainer", "run"]


class CoOpTrainer(BaseTrainer):
    # -- setup -----------------------------------------------------------------
    def setup_dataset(self):
        self.dataset = C.instantiate(self.cfg.dataset)
        self.labels = np.asarray(self.dataset.labels(), np.int64)
        rng = np.random.default_rng(int(self.cfg.meta.random_state))
        self.train_indices = balanced_indices(
            self.labels, int(self.cfg.dataset_info.get("k_shots", -1)), rng)
        self.val_dataset = C.instantiate(self.cfg.val_dataset) if self.cfg.get("val_dataset") else None
        self.val_labels = (np.asarray(self.val_dataset.labels(), np.int64)
                           if self.val_dataset else None)
        self.tokenizer = get_tokenizer()
        self.classes = list(self.cfg.prompting.classes or self.dataset.classes)

    def _load_gpt(self):
        """The fluency LM (ClipGPT), frozen, on the run's device; its CLIP
        token table is the CLIP tower's. None when ``gpt`` is unset."""
        gcfg = self.cfg.get("gpt")
        if not gcfg:
            return None
        ckpt_dir = gcfg.get("checkpoint_dir")
        if ckpt_dir and Path(ckpt_dir).exists():
            model = load_pretrained_clip_gpt(ckpt_dir, self.tokenizer, device=self.device)
            self.logger.log_info(f"Loaded ClipGPT from {ckpt_dir}")
        else:
            model = build_clip_gpt(
                {"gpt_config": str(gcfg.get("gpt_config", "test-gpt")),
                 "clip_emb_dim": int(self.clip_embs_table.shape[1]),
                 "adapters": {"emb_hid_dim": int(gcfg.get("emb_hid_dim", 1024)),
                              "head_hid_dim": gcfg.get("head_hid_dim", 1024)}},
                self.tokenizer.vocab_size, seed=0, device=self.device)
        with torch.no_grad():
            model.clip_emb.copy_(torch.from_numpy(self.clip_embs_table))
        return model.eval()

    def _proposer(self, head_cfg: tp.Optional[dict]):
        """Gumbelv3a1's proposer on the frozen fluency LM: ``head.kind``
        ``adapter`` (``hidden_dim``) or ``lora`` (``rank``)."""
        from summer_clip_torch.methods.gpt_heads import AdapterGPT, LoRAGPT

        if self.gpt_model is None:
            raise ValueError("prompt_model=gumbel_v3a1 needs a gpt config (+gpt.gpt_config=...)")
        head_cfg = head_cfg or {"kind": "adapter", "hidden_dim": 256}
        if str(head_cfg.get("kind", "adapter")) == "lora":
            return LoRAGPT(self.gpt_model, rank=int(head_cfg.get("rank", 8)))
        return AdapterGPT(self.gpt_model, hidden_dim=int(head_cfg.get("hidden_dim", 256)))

    def setup_model(self):
        cfg = self.cfg
        self.session = create_clip_session(cfg.clip.model_name, cfg.clip.get("checkpoint_path"),
                                           cfg.clip.get("dtype"), device=self.device,
                                           remat=cfg.clip.get("remat"), logger=self.logger)
        self.clip_embs_table = self.session.token_embedding_table()   # (V, D_text) f32
        self.embs_table = torch.from_numpy(self.clip_embs_table).to(self.device)
        self.logit_scale = self.session.logit_scale

        allowed = None
        if cfg.get("vocab_filter"):
            vf = C.instantiate(C.to_container(cfg.vocab_filter, resolve=True),
                               tokenizer=self.tokenizer)
            allowed = vf.get_allowed_tokens()

        prompt_len = int(cfg.prompt.length)
        init_ids = None
        if cfg.prompt.get("init_prompter"):
            prompter = C.instantiate(C.to_container(cfg.prompt.init_prompter, resolve=True))
            init_ids = prompter.get_ids(self.tokenizer)
            prompt_len = len(init_ids)
        self.prompt_len = prompt_len

        self.collator = PL.LeftPromptCollator(self.tokenizer, prompt_len,
                                              int(cfg.get("clip_seq_len", 77)))
        token_classes = self.collator.tokenize_classes(self.classes)
        self.class_table = self.collator.build_class_table(token_classes + [[]])  # + empty row
        self.logger.exp_logger.log_table(
            "token_classes", columns=["class", "token_ids"],
            rows=[[c, ids] for c, ids in zip(self.classes, token_classes)])
        # every class's row, embedded once in the tower's dtype; a step splices
        # the prompt into a copy
        ids, lens = self.collator.get_clip_input(self.class_table, np.arange(len(self.classes)))
        dtype = self.session.model.token_embedding.weight.dtype
        self.class_embeds = self.embs_table[ids.to(self.device)].to(dtype)
        self.class_lens = lens.to(self.device)

        # the fluency LM first: the Gumbelv3a1 proposer rides on it
        self.gpt_model = self._load_gpt()
        pm_cfg = C.to_container(cfg.prompt_model, resolve=True)
        if str(pm_cfg.get("_target_", "")).endswith("Gumbelv3a1"):
            pm_cfg.update(proposer=self._proposer(pm_cfg.pop("head", None)),
                          bos_token_id=self.tokenizer.sot_token)
        self.prompt_model = C.instantiate(
            pm_cfg, clip_embs=self.clip_embs_table, prompt_len=prompt_len,
            allowed_tokens=allowed, device=self.device)
        self.prompt_params = self.prompt_model.init(self.generator)
        if init_ids is not None and "prompt_embs" in self.prompt_params:
            self.prompt_params["prompt_embs"] = (
                self.embs_table[torch.as_tensor(init_ids, device=self.device)]
                .clone().requires_grad_())

        self.temp_scheduler = (C.instantiate(C.to_container(cfg.temp_scheduler, resolve=True))
                               if cfg.get("temp_scheduler") else None)
        lm_cfg = C.to_container(cfg.get("lm_loss") or
                                {"_target_": "summer_clip_torch.methods.prompt_learner.NoLMLoss"},
                                resolve=True)
        if lm_cfg.get("_target_", "").endswith("SuffixLMLoss"):
            lm_cfg.setdefault("prompt_len", prompt_len)
        self.lm_loss = C.instantiate(lm_cfg)
        tb_cfg = C.to_container(cfg.get("text_batcher") or
                                {"_target_": "summer_clip_torch.methods.prompt_learner.ImageTextBatcher"},
                                resolve=True)
        self.text_batcher = C.instantiate(tb_cfg, num_classes=len(self.classes),
                                          text_classes=self.classes)

        store = FeatureStore(cfg.store.root) if cfg.get("store") else None
        self.image_features = self._unit_features(resolve_features(cfg.data, store))
        self.val_image_features = None
        if cfg.data.get("val_features_key") or cfg.data.get("val_image_features_path"):
            self.val_image_features = self._unit_features(resolve_array(
                store, cfg.data.get("val_features_key"),
                cfg.data.get("val_image_features_path"), "features"))

    def _unit_features(self, feats) -> torch.Tensor:
        return F.normalize(torch.from_numpy(np.array(feats, np.float32)).to(self.device), dim=-1)

    def setup_optimizer(self):
        tcfg = self.cfg.training
        steps_per_epoch = max(len(self.train_indices) // int(self.cfg.data.batch_size), 1)
        total = int(tcfg.epochs_num) * steps_per_epoch
        schedule = warmup_cosine(float(tcfg.learning_rate), int(tcfg.get("warmup_steps", 0)), total)
        clip = tcfg.get("clip_grad_norm")
        base = adamw(self.prompt_params, schedule, weight_decay=float(tcfg.get("weight_decay", 0.0)),
                     grad_clip_norm=float(clip) if clip else None)
        self.tx = with_grad_accum(base, int(tcfg.get("accum_steps", 1)))

    def setup_loss(self):
        loss_cfg = self.cfg.loss
        self.w_clip = float(loss_cfg.get("clip", 1.0))
        self.w_fluency = float(loss_cfg.get("fluency", 0.0))
        self.w_entropy = float(loss_cfg.get("entropy", 0.0))

    # -- the loss ----------------------------------------------------------------
    def text_features_for(self, prompt_clip_embs: torch.Tensor) -> torch.Tensor:
        """All-class text features with the prompt spliced in, (C, D) f32."""
        embeds = PL.splice_prompt_embeds(self.class_embeds, prompt_clip_embs)
        return self.session.encode_text_embeds(embeds, self.class_lens).float()

    def loss_fn(self, prompt_params: dict, batch_feats: torch.Tensor, batch_labels: torch.Tensor,
                lm_class_idx: np.ndarray, temperature: float
                ) -> tp.Tuple[torch.Tensor, tp.Dict[str, torch.Tensor]]:
        model = self.prompt_model
        out = model.apply(prompt_params, temperature=temperature, training=True)
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        metrics: tp.Dict[str, torch.Tensor] = {}
        if self.w_clip:
            tf = F.normalize(self.text_features_for(out["clip_embs"]), dim=-1)
            logits = self.logit_scale * batch_feats @ tf.t()
            clip_ce = F.cross_entropy(logits, batch_labels)
            acc = (logits.argmax(1) == batch_labels).float().mean()
            total = total + self.w_clip * clip_ce
            metrics.update({"loss/clip": clip_ce, "acc/batch": acc * 100.0})
        if self.w_fluency and self.gpt_model is not None:
            ids, _, mask = self.collator.get_gpt_input(self.class_table, lm_class_idx,
                                                       prompt_ids=out["ids"])
            ids, mask = ids.to(self.device), mask.to(self.device)
            embeds = PL.splice_prompt_embeds(self.embs_table[ids], out["gpt_embs"])
            lm_out = self.gpt_model(inputs_embeds=embeds)
            fl = self.lm_loss.transform(ids, mask, lm_out["logits"])
            total = total + self.w_fluency * fl
            metrics["loss/fluency"] = fl
        if self.w_entropy and "weights/mean" in out:
            # Gumbel models: the entropy of the relaxed one-hot rows
            probs = torch.softmax(model.get_prompt_logits(prompt_params)
                                  / model.logits_temperature, dim=-1)
            ent = -(probs * torch.log(probs + 1e-9)).sum(-1).mean()
            total = total + self.w_entropy * ent
            metrics["loss/entropy"] = ent
        metrics["loss/total"] = total
        return total, metrics

    def train_step(self, batch_feats: torch.Tensor, batch_labels: torch.Tensor,
                   lm_class_idx: np.ndarray, temperature: float
                   ) -> tp.Tuple[tp.Dict[str, torch.Tensor], tp.Dict[str, torch.Tensor]]:
        """One optimizer call; returns the metrics and this step's raw gradients."""
        loss, metrics = self.loss_fn(self.prompt_params, batch_feats, batch_labels,
                                     lm_class_idx, temperature)
        self.tx.zero_grad()
        loss.backward()
        grads = {k: p.grad.detach().clone() for k, p in self.prompt_params.items()
                 if p.grad is not None}
        self.tx.step()
        return {k: v.detach() for k, v in metrics.items()}, grads

    # -- loops -------------------------------------------------------------------
    def train_epoch(self, epoch_num, epoch_info):
        bs = int(self.cfg.data.batch_size)
        rng = np.random.default_rng((int(self.cfg.meta.random_state), epoch_num))
        order = rng.permutation(self.train_indices)
        n_full = max((len(order) // bs) * bs, 0)
        labels = torch.from_numpy(self.labels).to(self.device)
        for s in range(0, n_full, bs):
            idx = order[s:s + bs]
            temp = self.temp_scheduler.get_val() if self.temp_scheduler else 1.0
            if self.temp_scheduler:
                self.temp_scheduler.step()
            lm_idx = self.text_batcher.get_batch_classes(self.labels[idx])
            dev_idx = torch.from_numpy(idx).to(self.device)
            metrics, grads = self.train_step(self.image_features[dev_idx], labels[dev_idx],
                                             lm_idx, temp)
            epoch_info.update_values({k: float(v) for k, v in metrics.items()})
            for k, v in self.prompt_model.step_info(grads).items():
                epoch_info.update_value(k, v)
        return epoch_info

    @torch.no_grad()
    def eval_full_accuracy(self, features: torch.Tensor, labels: np.ndarray
                           ) -> tp.Tuple[float, float]:
        out = self.prompt_model.apply(self.prompt_params, training=False)
        tf = F.normalize(self.text_features_for(out["clip_embs"]), dim=-1)
        return compute_accuracy(self.logit_scale * features @ tf.t(), labels)

    def compute_metrics(self, epoch_num, epoch_info):
        idx = torch.from_numpy(self.train_indices).to(self.device)
        a1, a5 = self.eval_full_accuracy(self.image_features[idx], self.labels[self.train_indices])
        epoch_info.update_values({"train/acc1": a1, "train/acc5": a5})
        if self.val_image_features is not None and self.val_labels is not None:
            v1, v5 = self.eval_full_accuracy(self.val_image_features, self.val_labels)
            epoch_info.update_values({"val/acc1": v1, "val/acc5": v5})

    def decode_prompt(self) -> tp.Tuple[tp.List[int], tp.List[str]]:
        ids = [int(i) for i in self.prompt_model.decode_ids(self.prompt_params)]
        return ids, [self.tokenizer.decoder.get(i, "?") for i in ids]

    def save_epoch_model(self, epoch_num):
        ids, tokens = self.decode_prompt()
        text = self.tokenizer.decode(ids)
        self.logger.log_info({"type": "prompt", "epoch": epoch_num, "prompt_ids": ids,
                              "prompt_tokens": tokens, "prompt_text": text})
        self.logger.exp_logger.log_table("prompts", columns=["epoch", "prompt_text", "prompt_ids"],
                                         rows=[[epoch_num, text, ids]])
        out_dir = Path(self.cfg.data.get("checkpoints_dir", "checkpoints")) / f"epoch_{epoch_num}"
        ckpt.save_checkpoint(out_dir, params=self.prompt_params,
                             meta={"prompt_ids": ids, "prompt_tokens": tokens, "epoch": epoch_num,
                                   "prompt_model": C.to_container(self.cfg.prompt_model,
                                                                  resolve=True)})
        (out_dir / "prompt.yaml").write_text(yaml.safe_dump(
            {"ids": ids, "tokens": tokens}, allow_unicode=True))


@C.main(config_path="../conf", config_name="train_coop")
def run(cfg) -> None:
    run_trainer(CoOpTrainer, cfg)


if __name__ == "__main__":
    run()
