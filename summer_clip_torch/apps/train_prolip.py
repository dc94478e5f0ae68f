"""ProLIP app: few-shot fine-tuning of the ViT vision projection.

Counterpart of ``summer_clip_tpu/apps/train_prolip.py`` (arXiv:2410.05270;
see ``methods/prolip.py``). As ``tip_adapter``: the few-shot train split ->
pre-projection features (the image tower, K5 and K6 on the card) -> W
trained against the frozen zero-shot text classifier -> zero-shot and ProLIP
test top-1. The tuned projection goes into the run's feature store
(``prolip_proj_{shots}shots``) and into ``prolip_proj.npy``, which
``clip.proj_path`` swaps into any downstream tower. Data parallel as in the
JAX app (``apps.common.data_parallel_mesh``): the feature extraction is split
over the ranks, and rank 0 alone trains and writes; the other ranks end after
the extraction.

Run: ``python -m summer_clip_torch.apps.train_prolip dataset=<name> shots=<k>``.
"""

from __future__ import annotations

import numpy as np

from summer_clip_torch.apps.common import (create_clip_session, data_parallel_mesh,
                                           data_parallel_world, extract_image_features,
                                           resolve_prompting)
from summer_clip_torch.core import config as C
from summer_clip_torch.data.views import DatasetView
from summer_clip_torch.engine.trainer import BaseTrainer, run_trainer
from summer_clip_torch.methods import prolip
from summer_clip_torch.methods.zeroshot import accuracy, zeroshot_classifier
from summer_clip_torch.store import FeatureStore

__all__ = ["ProLipTrainer", "run"]


class ProLipTrainer(BaseTrainer):
    dataset_view_cls = DatasetView

    @classmethod
    def world_size(cls, cfg) -> int:
        return data_parallel_world(cfg, int(cfg.data.batch_size))

    def setup_mesh(self):
        self.mesh = data_parallel_mesh(int(self.cfg.data.batch_size))

    def setup_model(self):
        cfg = self.cfg
        self.store = FeatureStore(f"./caches/{cfg.dataset}")
        self.session = create_clip_session(cfg.clip.model_name, cfg.clip.get("checkpoint_path"),
                                           cfg.clip.get("dtype"), device=self.device,
                                           logger=self.logger, mesh=self.mesh)
        size = self.session.input_size
        bs = int(cfg.data.batch_size)
        dn = bool(cfg.data.get("device_normalize", False))
        seed = int(cfg.meta.random_state)

        train_view = self.dataset_view_cls(str(cfg.dataset), "train", str(cfg.root_path),
                                           int(cfg.shots), input_size=size, seed=seed,
                                           device_normalize=dn)
        test_view = self.dataset_view_cls(str(cfg.dataset), "test", str(cfg.root_path), -1,
                                          input_size=size, device_normalize=dn)

        classes, templates = resolve_prompting(cfg, train_view)
        self.classifier = zeroshot_classifier(self.session.encode_text, classes, templates,
                                              device=self.device).cpu().numpy()

        self.logger.log_info("Extracting PRE-projection features (train/test).")
        self.train_pre, self.train_labels, _ = extract_image_features(
            self.session, train_view.batcher(batch_size=bs), preproj=True)
        self.test_pre, self.test_labels, _ = extract_image_features(
            self.session, test_view.batcher(batch_size=bs), preproj=True)
        self.W0 = self.session.vision_projection()

    def _top1(self, W: np.ndarray, split: str = "test") -> float:
        feats, labels = ((self.test_pre, self.test_labels) if split == "test"
                         else (self.train_pre, self.train_labels))
        logits = prolip.prolip_logits(feats, W, self.classifier, float(self.cfg.train.scale),
                                       device=self.device)
        return accuracy(logits, labels)[0]

    def train_loop(self):
        if not self.leads:
            return   # the other ranks end after the extractions
        tcfg = self.cfg.train
        acc0 = self._top1(self.W0)
        self.logger.log_info(f"**** Zero-shot CLIP's test accuracy: {acc0:.2f}. ****")
        self.logger.log_info({"type": "zero_shot", "acc1": acc0})

        W = prolip.train_projection(
            self.train_pre, self.train_labels, self.classifier, self.W0,
            epochs=int(tcfg.epochs), lr=float(tcfg.lr),
            weight_decay_to_init=float(tcfg.weight_decay_to_init),
            scale=float(tcfg.scale), log_fn=self.logger.log_info_wandb, device=self.device)

        acc = self._top1(W)
        self.logger.log_info(f"**** ProLIP's test accuracy: {acc:.2f}. ****")
        self.logger.log_info({"type": "prolip_result", "acc1": acc,
                              "acc1_zero_shot": acc0,
                              "acc1_train": self._top1(W, "train"),
                              "acc1_train_zero_shot": self._top1(self.W0, "train"),
                              "epochs": int(tcfg.epochs), "lr": float(tcfg.lr)})
        self.store.save(f"prolip_proj_{self.cfg.shots}shots", features=W,
                        meta={"model": self.session.cfg.name, "shots": int(self.cfg.shots),
                              "acc1": float(acc)})
        # a plain .npy for the clip.proj_path swap (create_clip_session)
        np.save("prolip_proj.npy", W)
        self.logger.log_info({"type": "prolip_proj_saved", "proj_path": "prolip_proj.npy"})


@C.main(config_path="../conf", config_name="train_prolip")
def run(cfg):
    return run_trainer(ProLipTrainer, cfg)


if __name__ == "__main__":
    run()
