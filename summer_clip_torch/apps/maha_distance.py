"""Mahalanobis-distance classifier (reference ``clip_searcher/maha_distance.py``).

Counterpart of ``summer_clip_tpu/apps/maha_distance.py``: covariance from
[cache image features; text features]; test images classified by the negative
Mahalanobis distance to each class text feature, the quadratic form as three
products (``methods.linalg.maha_logits``).

Run: ``python -m summer_clip_torch.apps.maha_distance data.features_key=<key>
cache.features_key=<key> store.root=<dir>``.
"""

from __future__ import annotations

import numpy as np
import torch

from summer_clip_torch.apps.class_projector import ClassProjector, norm_rows
from summer_clip_torch.apps.features_io import resolve_array
from summer_clip_torch.core import config as C
from summer_clip_torch.engine.trainer import run_trainer
from summer_clip_torch.methods.linalg import maha_logits
from summer_clip_torch.methods.zeroshot import compute_accuracy
from summer_clip_torch.store import FeatureStore


class MahaDistance(ClassProjector):
    def setup_model(self):
        super().setup_model()
        store = FeatureStore(self.cfg.store.root) if self.cfg.get("store") else None
        cache = np.array(resolve_array(store, self.cfg.cache.get("features_key"),
                                       self.cfg.cache.get("image_features_path"), "features"),
                         np.float32)
        self.cache_image_features = norm_rows(torch.from_numpy(cache).to(self.device))
        self.logger.log_info(f"cache image features shape: "
                             f"{tuple(self.cache_image_features.shape)}")

    def train_loop(self):
        logits = self.compute_clip_logits(self.test_image_features, self.test_text_features)
        a1, a5 = compute_accuracy(logits, self.test_labels)
        self.logger.log_info(f"zero-shot clip: acc@1={a1}, acc@5={a5}")

        m_logits = maha_logits(self.test_image_features, self.test_text_features,
                               self.cache_image_features, device=self.device)
        a1, a5 = compute_accuracy(m_logits, self.test_labels)
        self.logger.log_info(f"Maha clip: acc@1={a1}, acc@5={a5}")
        self.logger.log_info({"type": "maha_result", "acc1": a1, "acc5": a5})


@C.main(config_path="../conf", config_name="maha_distance")
def run(cfg) -> None:
    run_trainer(MahaDistance, cfg)


if __name__ == "__main__":
    run()
