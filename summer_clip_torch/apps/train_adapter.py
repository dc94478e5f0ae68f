"""Adapter training over cached features (contrastive CE).

Counterpart of ``summer_clip_tpu/apps/train_adapter.py``: small adapter heads
train on top of frozen, stored CLIP features with the symmetric CLIP-style
cross-entropy on in-batch diagonal labels, against the zero-shot text
classifier that the frozen text tower computes once (through K5 / K6 on the
card). AdamW as optax's ``adamw`` (weight decay on every parameter).
Per-epoch checkpoints keep the adapter's parameters, optimizer state and, in
``meta.yaml``, what rebuilds it (``eval_adapter`` reads them).

Run: ``python -m summer_clip_torch.apps.train_adapter data.features_key=<key>``
(``meta.device=cpu`` forces the CPU).
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from summer_clip_torch.apps.common import create_clip_session
from summer_clip_torch.apps.features_io import resolve_features
from summer_clip_torch.core import config as C
from summer_clip_torch.engine import checkpoint as ckpt
from summer_clip_torch.engine.optim import adamw
from summer_clip_torch.engine.trainer import BaseTrainer, run_trainer
from summer_clip_torch.methods.zeroshot import compute_accuracy, zeroshot_classifier
from summer_clip_torch.store import FeatureStore

__all__ = ["balanced_indices", "ClipAdapterTrainer", "run"]


def balanced_indices(labels: np.ndarray, k_shots: int,
                     rng: np.random.Generator) -> np.ndarray:
    """Balanced k-shot subsample of dataset indices (k_shots < 1 = all)."""
    if k_shots < 1:
        return np.arange(labels.shape[0])
    picks = []
    for c in np.unique(labels):
        rows = np.flatnonzero(labels == c)
        k = min(k_shots, rows.shape[0])
        picks.append(rng.choice(rows, size=k, replace=False))
    return np.sort(np.concatenate(picks))


class ClipAdapterTrainer(BaseTrainer):
    def setup_dataset(self):
        self.dataset = C.instantiate(self.cfg.dataset)
        self.labels = np.asarray(self.dataset.labels(), np.int64)
        rng = np.random.default_rng(int(self.cfg.meta.random_state))
        indices = balanced_indices(self.labels, int(self.cfg.data.get("k_shots", -1)), rng)
        val_size = int(self.cfg.data.get("validation_size", 0))
        perm = rng.permutation(len(indices))
        self.val_indices = indices[perm[:val_size]]
        self.train_indices = indices[perm[val_size:]]

    def setup_model(self):
        store = FeatureStore(self.cfg.store.root) if self.cfg.get("store") else None
        self.features = torch.from_numpy(np.array(
            resolve_features(self.cfg.data, store), np.float32)).to(self.device)
        session = create_clip_session(self.cfg.clip.model_name,
                                      self.cfg.clip.get("checkpoint_path"),
                                      self.cfg.clip.get("dtype"), device=self.device,
                                      remat=self.cfg.clip.get("remat"), logger=self.logger,
                                      quant=self.cfg.clip.get("quant"))
        classes = self.cfg.prompting.classes or self.dataset.classes
        self.text_features = zeroshot_classifier(session.encode_text, classes,
                                                 self.cfg.prompting.templates,
                                                 device=self.device).float()
        fabric = C.instantiate(self.cfg.adapter)
        self.adapter = fabric.create_adapter(self.features.shape[1]).init_weights(
            self.generator).to(self.device)

    def setup_optimizer(self):
        ap = self.cfg.training.adam_params
        self.tx = adamw(self.adapter.named_parameters(), float(ap.lr),
                        b1=float(ap.get("b1", 0.9)), b2=float(ap.get("b2", 0.999)),
                        eps=float(ap.get("eps", 1e-8)),
                        weight_decay=float(ap.get("weight_decay", 0.0)))

    def train_step(self, feats: torch.Tensor, text_feats: torch.Tensor) -> torch.Tensor:
        li, lt = self.adapter(feats, text_feats)
        targets = torch.arange(li.shape[0], device=li.device)
        loss = (F.cross_entropy(li, targets) + F.cross_entropy(lt, targets)) / 2
        self.tx.zero_grad()
        loss.backward()
        self.tx.step()
        return loss.detach()

    def train_epoch(self, epoch_num, epoch_info):
        bs = int(self.cfg.data.batch_size)
        rng = np.random.default_rng((int(self.cfg.meta.random_state), epoch_num))
        order = rng.permutation(self.train_indices)
        n_full = (len(order) // bs) * bs
        labels = torch.from_numpy(self.labels).to(self.device)
        for s in range(0, n_full, bs):
            idx = torch.from_numpy(order[s:s + bs]).to(self.device)
            loss = self.train_step(self.features[idx], self.text_features[labels[idx]])
            epoch_info.update_value("train/loss", float(loss))
        return epoch_info

    @torch.no_grad()
    def _eval_accuracy(self, indices: np.ndarray) -> tp.Tuple[float, float]:
        feats = F.normalize(self.adapter.encode(self.features[torch.from_numpy(indices).to(
            self.device)]), dim=-1)
        return compute_accuracy(100.0 * feats @ self.text_features.t(), self.labels[indices])

    def compute_metrics(self, epoch_num, epoch_info):
        a1, a5 = self._eval_accuracy(self.train_indices)
        epoch_info.update_values({"train/acc1": a1, "train/acc5": a5})
        if len(self.val_indices):
            v1, v5 = self._eval_accuracy(self.val_indices)
            epoch_info.update_values({"val/acc1": v1, "val/acc5": v5})

    def save_epoch_model(self, epoch_num):
        ckpt.save_checkpoint(
            f"{self.cfg.data.checkpoints_dir}/epoch_{epoch_num}",
            params=dict(self.adapter.state_dict()), opt_state=self.tx.state_dict(),
            meta={
                "adapter": C.to_container(self.cfg.adapter, resolve=True),
                "clip": C.to_container(self.cfg.clip, resolve=True),
                "prompting": C.to_container(self.cfg.prompting, resolve=True),
                "emb_dim": int(self.features.shape[1]),
                "epoch": epoch_num,
            })


@C.main(config_path="../conf", config_name="train_adapter")
def run(cfg) -> None:
    run_trainer(ClipAdapterTrainer, cfg)


if __name__ == "__main__":
    run()
