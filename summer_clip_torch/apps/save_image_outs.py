"""Recompute image_outs (f_hat @ classifier.T) from stored features.

Counterpart of ``summer_clip_tpu/apps/save_image_outs.py`` (rebuild of
``summer_clip/clip_searcher/save_image_outs.py``): the text tower builds the
zero-shot classifier, the stored features of a split are scored against it at
scale 1, and the logits land in the feature store (``data.output_key``) or in
an ``.npy`` file. CLIP-search takes its pseudo-labels from them.

Run: ``python -m summer_clip_torch.apps.save_image_outs data.features_key=<key>
data.output_key=<key>``.
"""

from __future__ import annotations

import numpy as np
import torch

from summer_clip_torch.apps.common import create_clip_session
from summer_clip_torch.apps.features_io import resolve_features
from summer_clip_torch.core import config as C
from summer_clip_torch.engine.trainer import BaseTrainer, run_trainer
from summer_clip_torch.methods.zeroshot import clip_logits, zeroshot_classifier
from summer_clip_torch.store import FeatureStore, save_array


class SaveImageOuts(BaseTrainer):
    def setup_dataset(self):
        self.dataset = C.instantiate(self.cfg.dataset)

    def setup_model(self):
        session = create_clip_session(self.cfg.clip.model_name,
                                      self.cfg.clip.get("checkpoint_path"),
                                      self.cfg.clip.get("dtype"), device=self.device,
                                      logger=self.logger, quant=self.cfg.clip.get("quant"))
        classes = self.cfg.prompting.classes or self.dataset.classes
        self.classifier = zeroshot_classifier(session.encode_text, classes,
                                              self.cfg.prompting.templates, device=self.device)
        self.store = FeatureStore(self.cfg.store.root) if self.cfg.get("store") else None
        self.features = np.array(resolve_features(self.cfg.data, self.store), np.float32)

    def train_loop(self):
        self.logger.log_info("Computing outputs...")
        feats = torch.from_numpy(self.features).to(self.device)
        outs = clip_logits(feats, self.classifier, scale=1.0).cpu().numpy().astype(np.float32)
        out_key = self.cfg.data.get("output_key")
        if out_key and self.store is not None:
            self.store.save(out_key, outs=outs)
            self.logger.log_info({"type": "outs_saved", "key": out_key})
        else:
            save_array(self.cfg.data.output_image_outs, outs)
            self.logger.log_info({"type": "outs_saved", "path": str(self.cfg.data.output_image_outs)})


@C.main(config_path="../conf", config_name="save_image_outs")
def run(cfg) -> None:
    run_trainer(SaveImageOuts, cfg)


if __name__ == "__main__":
    run()
