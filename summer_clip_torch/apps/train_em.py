"""Fixed-means GMM-EM over image features (reference ``clip_em/train_em.py``).

Counterpart of ``summer_clip_tpu/apps/train_em.py``: component means are the
class text features; EM fits the weights and covariances on the normalized
image features; the joint log-densities act as logits. The fitted model is
saved with ``engine.checkpoint.save_pytree`` (``torch.save``; the JAX package
writes msgpack).

Run: ``python -m summer_clip_torch.apps.train_em data.features_key=<key>
store.root=<dir> em_model.covariance_type=diag``.
"""

from __future__ import annotations

from summer_clip_torch.apps.class_projector import ClassProjector
from summer_clip_torch.core import config as C
from summer_clip_torch.engine.checkpoint import save_pytree
from summer_clip_torch.engine.trainer import run_trainer
from summer_clip_torch.methods.em import FixedMeansGMM
from summer_clip_torch.methods.zeroshot import compute_accuracy


class ClipEM(ClassProjector):
    def train_loop(self):
        logits = self.compute_clip_logits(self.test_image_features, self.test_text_features)
        a1, a5 = compute_accuracy(logits, self.test_labels)
        self.logger.log_info(f"Zero-shot CLIP: acc@1: {a1}, acc@5: {a5}")

        em_cfg = C.to_container(self.cfg.em_model, resolve=True)
        em_cfg.pop("_target_", None)
        model = FixedMeansGMM(means_init=self.test_text_features, device=self.device, **em_cfg)
        model.fit(self.test_image_features)
        em_logits = model.predict_log_proba(self.test_image_features)
        a1, a5 = compute_accuracy(em_logits, self.test_labels)
        self.logger.log_info(f"EM-CLIP: acc@1: {a1}, acc@5: {a5}")
        self.logger.log_info({"type": "em_result", "acc1": a1, "acc5": a5})

        save_pytree(self.cfg.save_model.name,
                    {"weights": model.weights_, "covariances": model.covariances_,
                     "means": model.means})
        self.logger.log_info("Model was saved!")


@C.main(config_path="../conf", config_name="train_em")
def run(cfg) -> None:
    run_trainer(ClipEM, cfg)


if __name__ == "__main__":
    run()
