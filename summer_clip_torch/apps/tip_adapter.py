"""Tip-Adapter app: training-free cache baseline end to end.

Counterpart of ``summer_clip_tpu/apps/tip_adapter.py``, composed from the port's
copy of its config: few-shot cache construction from augment passes over the train split,
zero-shot and Tip-Adapter accuracy at the initial (beta, alpha), then the
beta x alpha grid search through the label-driven cache kernels (K3 for the
class-grouped Tip cache). With ``finetune.enabled=true`` Tip-Adapter-F then
trains the cache keys (``methods.tip.finetune_cache_keys``) on the un-augmented
few-shot train split, saves them as ``cache_{shots}shots_finetuned`` and
writes ``tipf_result`` and ``tipf_searched``.

Data parallel, as in the JAX app: with several cards (``meta.world_size``
ranks when set) and a batch that divides over them, every image extraction
is split over the ranks (``apps.common.data_parallel_mesh``); rank 0 writes
the store and runs the search, the other ranks end after the extractions.

Run: ``python -m summer_clip_torch.apps.tip_adapter dataset=<name> shots=16``;
:func:`run_imagenet` is the same app with the ImageNet prompt-ensemble config
(``conf/tip_adapter_imagenet.yaml``).
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from summer_clip_torch.apps.common import (create_clip_session, data_parallel_mesh,
                                           data_parallel_world, extract_image_features,
                                           resolve_prompting)
from summer_clip_torch.core import config as C
from summer_clip_torch.data.views import DatasetView
from summer_clip_torch.engine.trainer import BaseTrainer, run_trainer
from summer_clip_torch.methods import tip as tip_methods
from summer_clip_torch.methods.zeroshot import accuracy, zeroshot_classifier
from summer_clip_torch.store import FeatureStore


class TipAdapterTrainer(BaseTrainer):
    dataset_view_cls = DatasetView

    @classmethod
    def world_size(cls, cfg) -> int:
        return data_parallel_world(cfg, int(cfg.data.batch_size))

    def setup_mesh(self):
        self.mesh = data_parallel_mesh(int(self.cfg.data.batch_size))

    def setup_model(self):
        cfg = self.cfg
        self.store = FeatureStore(f"./caches/{cfg.dataset}")
        self.session = create_clip_session(cfg.clip.model_name,
                                           cfg.clip.get("checkpoint_path"),
                                           cfg.clip.get("dtype"), device=self.device,
                                           logger=self.logger,
                                           proj_path=cfg.clip.get("proj_path"),
                                           quant=cfg.clip.get("quant"), mesh=self.mesh)
        size = self.session.input_size
        bs = int(cfg.data.batch_size)
        shots = int(cfg.shots)
        root = str(cfg.root_path)

        self.logger.log_info("Preparing dataset.")
        dn = bool(cfg.data.get("device_normalize", False))
        train_view = self.dataset_view_cls(str(cfg.dataset), "train", root, shots,
                                           input_size=size, is_train=True,
                                           seed=int(cfg.meta.random_state), device_normalize=dn)
        val_view = self.dataset_view_cls(str(cfg.dataset), "val", root, -1, input_size=size,
                                         device_normalize=dn)
        test_view = self.dataset_view_cls(str(cfg.dataset), "test", root, -1, input_size=size,
                                          device_normalize=dn)
        self.num_classes = train_view.base.num_classes

        self.logger.log_info("Getting textual features as CLIP's classifier.")
        classes, templates = resolve_prompting(cfg, train_view)
        self.clip_weights = zeroshot_classifier(self.session.encode_text, classes, templates,
                                                device=self.device)

        self.logger.log_info("Constructing cache model by few-shot visual features and labels.")
        self.cache_keys, self.cache_values = self.build_cache_model(train_view, bs)
        # values are strict one-hots: the per-row labels route the sweeps
        # through the label-driven kernels
        self.cache_key_labels = np.argmax(self.cache_values, axis=1).astype(np.int32)

        self.logger.log_info("Loading visual features and labels from val set.")
        self.val_features, self.val_labels = self.preload_features("val", val_view, bs)
        self.logger.log_info("Loading visual features and labels from test set.")
        self.test_features, self.test_labels = self.preload_features("test", test_view, bs)

        if self._finetune_enabled():
            # Tip-Adapter-F trains on the (un-augmented) few-shot train split
            self.logger.log_info("Loading train features for Tip-Adapter-F.")
            self.train_features, self.train_labels = self.preload_features(
                "train_eval", self.dataset_view_cls(
                    str(cfg.dataset), "train", root, shots, input_size=size,
                    seed=int(cfg.meta.random_state), device_normalize=dn), bs)

    def _finetune_enabled(self) -> bool:
        fcfg = self.cfg.get("finetune")
        return bool(fcfg and fcfg.get("enabled", False))

    # -- cache construction ------------------------------------------------------
    def build_cache_model(self, train_view: DatasetView, batch_size: int
                          ) -> tp.Tuple[np.ndarray, np.ndarray]:
        key = f"cache_{self.cfg.shots}shots"
        if bool(self.cfg.load_cache) and key in self.store:
            arrs = self.store.load_all(key, mmap=False)
            return np.asarray(arrs["features"]), np.asarray(arrs["values"])
        passes = []
        labels = None
        for epoch in range(int(self.cfg.augment_epoch)):
            self.logger.log_info(f"Augment Epoch: {epoch} / {int(self.cfg.augment_epoch)}")
            batcher = train_view.batcher(batch_size=batch_size, seed=int(self.cfg.meta.random_state))
            batcher.set_epoch(epoch)
            feats, lab, _ = extract_image_features(self.session, batcher)
            passes.append(feats)
            if labels is None:
                labels = lab
        keys, values = tip_methods.build_cache_from_features(passes, labels, self.num_classes)
        if self.leads:
            self.store.save(key, features=keys, extra={"values": values},
                            meta={"shots": int(self.cfg.shots)})
        return keys, values

    def preload_features(self, split: str, view: DatasetView, batch_size: int
                         ) -> tp.Tuple[np.ndarray, np.ndarray]:
        key = f"{split}_features"
        if bool(self.cfg.load_pre_feat) and key in self.store:
            arrs = self.store.load_all(key, mmap=False)
            return np.asarray(arrs["features"]), np.asarray(arrs["labels"])
        feats, labels, _ = extract_image_features(self.session, view.batcher(batch_size=batch_size))
        feats = feats / np.maximum(np.linalg.norm(feats, axis=-1, keepdims=True), 1e-12)
        if self.leads:
            self.store.save(key, features=feats, labels=labels)
        return feats, labels

    # -- evaluation ---------------------------------------------------------------
    def _clip_logits(self, feats: np.ndarray) -> torch.Tensor:
        return 100.0 * torch.from_numpy(feats).to(self.device) @ self.clip_weights.t()

    def _search(self, keys: np.ndarray, clip_logits: torch.Tensor
                ) -> tp.Tuple[float, float, float, float]:
        """The (beta, alpha) grid search over ``keys`` on val (on test when the
        dataset has no val split): (beta, alpha, search accuracy, test
        accuracy at that point)."""
        cfg = self.cfg
        feats, labels = ((self.val_features, self.val_labels) if len(self.val_features)
                         else (self.test_features, self.test_labels))
        beta, alpha, acc = tip_methods.search_hp(
            feats, labels, self._clip_logits(feats), keys, self.cache_values,
            search_scale=list(cfg.search_scale), search_step=list(cfg.search_step),
            log_fn=self.logger.log_info_wandb, cache_labels=self.cache_key_labels,
            device=self.device)
        tip = tip_methods.tip_logits(clip_logits, self.test_features, keys, self.cache_values,
                                     beta, alpha, cache_labels=self.cache_key_labels,
                                     device=self.device)
        return beta, alpha, acc, accuracy(tip, self.test_labels)[0]

    def train_loop(self):
        if not self.leads:
            return   # the other ranks end after the extractions
        cfg = self.cfg
        dev = self.device
        clip_logits = self._clip_logits(self.test_features)
        acc = accuracy(clip_logits, self.test_labels)[0]
        self.logger.log_info(f"**** Zero-shot CLIP's test accuracy: {acc:.2f}. ****")
        self.logger.log_info({"type": "zero_shot", "acc1": acc})

        beta, alpha = float(cfg.init_beta), float(cfg.init_alpha)
        tip = tip_methods.tip_logits(clip_logits, self.test_features, self.cache_keys,
                                     self.cache_values, beta, alpha,
                                     cache_labels=self.cache_key_labels, device=dev)
        acc_tip = accuracy(tip, self.test_labels)[0]
        self.logger.log_info(f"**** Tip-Adapter's test accuracy: {acc_tip:.2f}. ****")
        self.logger.log_info({"type": "tip_result", "beta": beta, "alpha": alpha, "acc1": acc_tip})

        if bool(cfg.search_hp):
            best_beta, best_alpha, best_acc, acc_best = self._search(self.cache_keys,
                                                                     clip_logits)
            self.logger.log_info(
                f"After searching, the best accuracy: {best_acc:.2f} "
                f"(beta={best_beta:.2f}, alpha={best_alpha:.2f}).")
            self.logger.log_info(f"**** Tip-Adapter's searched test accuracy: {acc_best:.2f}. ****")
            self.logger.log_info({"type": "tip_searched", "beta": best_beta,
                                  "alpha": best_alpha, "acc1": acc_best})

        if self._finetune_enabled():
            self.run_finetune(clip_logits, beta, alpha)

    def run_finetune(self, clip_logits: torch.Tensor, beta: float, alpha: float) -> None:
        """Tip-Adapter-F: trainable cache keys, then the same records as the
        training-free cache (``tipf_result``, ``tipf_searched``)."""
        cfg = self.cfg
        fcfg = cfg.finetune
        dev = self.device
        keys_f = tip_methods.finetune_cache_keys(
            self.train_features, self.train_labels, self._clip_logits(self.train_features),
            self.cache_keys, self.cache_values, beta, alpha,
            epochs=int(fcfg.get("epochs", 20)), lr=float(fcfg.get("lr", 1e-3)),
            batch_size=int(fcfg.get("batch_size", 256)), seed=int(cfg.meta.random_state),
            log_fn=self.logger.log_info_wandb, device=dev)
        self.store.save(f"cache_{cfg.shots}shots_finetuned", features=keys_f,
                        extra={"values": self.cache_values})

        tip_f = tip_methods.tip_logits(clip_logits, self.test_features, keys_f,
                                       self.cache_values, beta, alpha,
                                       cache_labels=self.cache_key_labels, device=dev)
        acc_f = accuracy(tip_f, self.test_labels)[0]
        self.logger.log_info(f"**** Tip-Adapter-F's test accuracy: {acc_f:.2f}. ****")
        self.logger.log_info({"type": "tipf_result", "beta": beta, "alpha": alpha,
                              "acc1": acc_f})

        if bool(cfg.search_hp):
            b_beta, b_alpha, _, acc_fb = self._search(keys_f, clip_logits)
            self.logger.log_info(
                f"**** Tip-Adapter-F searched test accuracy: {acc_fb:.2f} "
                f"(beta={b_beta:.2f}, alpha={b_alpha:.2f}). ****")
            self.logger.log_info({"type": "tipf_searched", "beta": b_beta,
                                  "alpha": b_alpha, "acc1": acc_fb})


@C.main(config_path="../conf", config_name="tip_adapter")
def run(cfg):
    return run_trainer(TipAdapterTrainer, cfg)


@C.main(config_path="../conf", config_name="tip_adapter_imagenet")
def run_imagenet(cfg):
    return run_trainer(TipAdapterTrainer, cfg)


if __name__ == "__main__":
    run()
