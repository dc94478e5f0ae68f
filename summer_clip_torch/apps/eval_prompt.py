"""Evaluate explicit prompts (texts or token ids) as zero-shot classifiers.

Counterpart of ``summer_clip_tpu/apps/eval_prompt.py``: for each class, build
``[SOT] + prompt + class + [EOT]`` rows for every prompt of the ensemble,
encode them through the frozen text tower (K5 / K6 on the card) in chunks of
256, average, and score stored image features; acc@1/5 go into an
``eval_prompt`` record.

Run: ``python -m summer_clip_torch.apps.eval_prompt clip_data.features_key=<key>
'prompts_texts=["a photo of a"]'`` (or ``prompts_ids=[[...]]``).
"""

from __future__ import annotations

import logging
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from summer_clip_torch.apps.common import create_clip_session
from summer_clip_torch.apps.features_io import resolve_features
from summer_clip_torch.core import config as C
from summer_clip_torch.engine.trainer import BaseTrainer, run_trainer
from summer_clip_torch.methods.zeroshot import compute_accuracy
from summer_clip_torch.models.tokenizer import get_tokenizer
from summer_clip_torch.store import FeatureStore


def create_text_features(session, tokenizer, classes_tokens, prompts_tokens,
                         context_length: int = 77) -> torch.Tensor:
    """(C, D) ensemble classifier from explicit prompt-id lists, f32 on the
    session's device."""
    sot, eot = tokenizer.sot_token, tokenizer.eot_token
    rows, row_class = [], []
    for ci, ctoks in enumerate(classes_tokens):
        for ptoks in prompts_tokens:
            ids = [sot] + list(ptoks) + list(ctoks) + [eot]
            if len(ids) > context_length:  # truncate, keeping the final EOT
                ids = ids[:context_length]
                ids[-1] = eot
            row = np.zeros((context_length,), np.int64)
            row[:len(ids)] = ids
            rows.append(row)
            row_class.append(ci)
    tokens = torch.from_numpy(np.stack(rows))
    feats = F.normalize(torch.cat([session.encode_text(tokens[s:s + 256])
                                   for s in range(0, len(tokens), 256)]).float(), dim=-1)
    row_class = torch.as_tensor(row_class, device=feats.device)
    return torch.stack([F.normalize(feats[row_class == ci].mean(dim=0), dim=-1)
                        for ci in range(len(classes_tokens))])


class PromptEvaluator(BaseTrainer):
    def setup_dataset(self):
        self.dataset = C.instantiate(self.cfg.dataset)
        self.labels = np.asarray(self.dataset.labels(), np.int64)
        self.tokenizer = get_tokenizer()
        self.text_classes = list(self.cfg.prompting.classes or self.dataset.classes)
        self.token_classes = [self.tokenizer.encode(str(c).replace("_", " "))
                              for c in self.text_classes]

    def setup_prompts(self):
        ids_given = self.cfg.get("prompts_ids") is not None
        texts_given = self.cfg.get("prompts_texts") is not None
        assert ids_given ^ texts_given, "Only one is allowed: text or ids"
        if ids_given:
            self.token_prompts: tp.List[tp.List[int]] = [
                list(p) for p in C.to_container(self.cfg.prompts_ids, resolve=True)]
        else:
            self.token_prompts = [self.tokenizer.encode(t) for t in self.cfg.prompts_texts]

    def setup_model(self):
        self.session = create_clip_session(self.cfg.clip.model_name,
                                           self.cfg.clip.get("checkpoint_path"),
                                           self.cfg.clip.get("dtype"), device=self.device,
                                           remat=self.cfg.clip.get("remat"), logger=self.logger,
                                           quant=self.cfg.clip.get("quant"))
        store = FeatureStore(self.cfg.store.root) if self.cfg.get("store") else None
        feats = torch.from_numpy(np.array(resolve_features(self.cfg.clip_data, store),
                                          np.float32)).to(self.device)
        self.image_features = F.normalize(feats, dim=-1)
        self.setup_prompts()
        self.text_features = create_text_features(
            self.session, self.tokenizer, self.token_classes, self.token_prompts)

    def train_loop(self):
        logits = 100.0 * self.image_features @ self.text_features.t()
        top1, top5 = compute_accuracy(logits, self.labels)
        logging.info(f"acc@1: {top1}")
        logging.info(f"acc@5: {top5}")
        self.logger.log_info({"type": "eval_prompt", "acc1": top1, "acc5": top5,
                              "prompts": [list(p) for p in self.token_prompts]})


@C.main(config_path="../conf", config_name="eval_prompt")
def run(cfg) -> None:
    run_trainer(PromptEvaluator, cfg)


if __name__ == "__main__":
    run()
