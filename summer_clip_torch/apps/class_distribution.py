"""Class-distribution analysis (reference ``clip_searcher/class_distribution.py``;
counterpart of ``summer_clip_tpu/apps/class_distribution.py``).

ImageAttention subclass that forces gold-label cache values and dumps the
selected cache's predicted labels per strategy for notebook analysis.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from summer_clip_torch.apps.image_attention import ImageAttention
from summer_clip_torch.core import config as C
from summer_clip_torch.engine.trainer import run_trainer


class ClassDistribution(ImageAttention):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.cfg.cache["replace_outs_with_golds"] = True

    def train_loop(self):
        out_dir = Path("selected_cache")
        out_dir.mkdir(parents=True, exist_ok=True)
        strategy_cfgs = (self.cfg.cache_strategies.values()
                         if self.cfg.get("cache_strategies")
                         else [self.cfg.cache_strategy])
        for strategy_cfg in strategy_cfgs:
            raw = C.to_container(strategy_cfg, resolve=True)
            for strategy, params in C.instantiate_all(self._inject_context(raw)):
                params = {k: v for k, v in params.items() if not isinstance(v, np.ndarray)}
                _, cache_outs, _ = self.build_cache(
                    strategy, self.origin_cache_image_features, self.origin_cache_image_outs)
                labels = cache_outs.argmax(axis=1)
                np.save(out_dir / f"{json.dumps(params)}.npy", labels)
        np.save("test_labels.npy", self.test_labels)
        assert self.cache_labels is not None, "cache_labels are none"
        np.save("cache_labels.npy", self.cache_labels)
        self.logger.log_info({"type": "class_distribution_saved",
                              "dir": str(out_dir.resolve())})


@C.main(config_path="../conf", config_name="image_attention")
def run(cfg) -> None:
    run_trainer(ClassDistribution, cfg)


if __name__ == "__main__":
    run()
