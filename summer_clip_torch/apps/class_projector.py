"""PCA class-projection analysis (reference ``clip_searcher/class_projector.py``).

Counterpart of ``summer_clip_tpu/apps/class_projector.py``: fit PCA on the class
text features (the prompt-ensemble classifier, through the text tower's
kernels on the card), project the stored image features into the same
subspace, and re-evaluate zero-shot accuracy for each ``n_components``.

Run: ``python -m summer_clip_torch.apps.class_projector dataset=<name>
data.features_key=<key> store.root=<dir>``.
"""

from __future__ import annotations

import numpy as np
import torch

from summer_clip_torch.apps.common import create_clip_session
from summer_clip_torch.apps.features_io import resolve_features
from summer_clip_torch.core import config as C
from summer_clip_torch.engine.trainer import BaseTrainer, run_trainer
from summer_clip_torch.methods.linalg import PCA
from summer_clip_torch.methods.zeroshot import compute_accuracy, zeroshot_classifier
from summer_clip_torch.store import FeatureStore


def norm_rows(x) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=torch.float32)
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


class ClassProjector(BaseTrainer):
    def setup_dataset(self):
        self.dataset = C.instantiate(self.cfg.dataset)
        self.test_labels = np.asarray(self.dataset.labels(), np.int64)

    def setup_model(self):
        session = create_clip_session(self.cfg.clip.model_name,
                                      self.cfg.clip.get("checkpoint_path"),
                                      self.cfg.clip.get("dtype"), device=self.device,
                                      logger=self.logger, quant=self.cfg.clip.get("quant"),
                                      remat=self.cfg.clip.get("remat"))
        classes = self.cfg.prompting.classes or self.dataset.classes
        with torch.no_grad():
            self.test_text_features = zeroshot_classifier(
                session.encode_text, classes, self.cfg.prompting.templates, device=self.device)
        self.logger.log_info(f"text features shape: {tuple(self.test_text_features.shape)}")
        store = FeatureStore(self.cfg.store.root) if self.cfg.get("store") else None
        feats = torch.from_numpy(np.array(resolve_features(self.cfg.data, store), np.float32))
        self.test_image_features = norm_rows(feats.to(self.device))
        self.logger.log_info(f"image features shape: {tuple(self.test_image_features.shape)}")

    @staticmethod
    def compute_clip_logits(image_features, text_features) -> torch.Tensor:
        return 100.0 * norm_rows(image_features) @ norm_rows(text_features).t()

    def train_loop(self):
        logits = self.compute_clip_logits(self.test_image_features, self.test_text_features)
        a1, a5 = compute_accuracy(logits, self.test_labels)
        self.logger.log_info(f"zero-shot clip: acc@1={a1}, acc@5={a5}")

        for n_components in self.cfg.pca.n_components:
            pca = PCA(int(n_components), device=self.device)
            txt = pca.fit_transform(self.test_text_features)
            img = pca.transform(self.test_image_features)
            a1, a5 = compute_accuracy(self.compute_clip_logits(img, txt), self.test_labels)
            self.logger.log_info({"n_components": int(n_components), "acc1": a1, "acc5": a5})


@C.main(config_path="../conf", config_name="class_projector")
def run(cfg) -> None:
    run_trainer(ClassProjector, cfg)


if __name__ == "__main__":
    run()
