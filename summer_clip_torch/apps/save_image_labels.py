"""Dump (optionally one-hot) gold labels of a split.

Counterpart of ``summer_clip_tpu/apps/save_image_labels.py`` (rebuild of
``summer_clip/clip_searcher/save_image_labels.py``); host-side numpy only.

Run: ``python -m summer_clip_torch.apps.save_image_labels data.output_labels=<path>``.
"""

from __future__ import annotations

import numpy as np

from summer_clip_torch.core import config as C
from summer_clip_torch.engine.trainer import BaseTrainer, run_trainer
from summer_clip_torch.store import save_array


class SaveImageLabels(BaseTrainer):
    def setup_dataset(self):
        self.dataset = C.instantiate(self.cfg.dataset)

    def train_loop(self):
        labels = np.asarray(self.dataset.labels(), np.int64)
        if bool(self.cfg.data.get("one_hot", True)):
            c = int(labels.max()) + 1
            out = np.zeros((labels.shape[0], c), np.float32)
            out[np.arange(labels.shape[0]), labels] = 1.0
        else:
            out = labels
        save_array(self.cfg.data.output_labels, out)
        self.logger.log_info({"type": "labels_saved", "path": str(self.cfg.data.output_labels),
                              "shape": list(out.shape)})


@C.main(config_path="../conf", config_name="save_image_labels")
def run(cfg) -> None:
    run_trainer(SaveImageLabels, cfg)


if __name__ == "__main__":
    run()
