"""Feature-extraction app: stream train+test splits through the frozen image
tower once and persist the features for every downstream method.

Counterpart of ``summer_clip_tpu/apps/save_features.py``, composed from the
port's copy of its config (``summer_clip_torch/conf/save_features.yaml``). Features land in the
:class:`FeatureStore` under the same catalog keys
``<dataset>_{train,test}-<model>`` with the same (N, D) row layout, so either
package reads what the other wrote.

Run: ``python -m summer_clip_torch.apps.save_features dataset_name=sun397``.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from summer_clip_torch.apps.common import create_clip_session, extract_image_features
from summer_clip_torch.core import config as C
from summer_clip_torch.engine.trainer import make_logger, resolve_device
from summer_clip_torch.methods.zeroshot import clip_logits, zeroshot_classifier
from summer_clip_torch.store import FeatureStore


def save_split_features(cfg, session, store: FeatureStore, dataset_cfg, key: str,
                        save_outs: bool, logger) -> None:
    view = C.instantiate(dataset_cfg)
    view.transform.input_size = session.input_size
    if hasattr(view.transform, "device_normalize"):
        # ship raw uint8 to the device; normalization runs there
        view.transform.device_normalize = bool(cfg.data.get("device_normalize", False))
    batcher = view.batcher(batch_size=int(cfg.data.batch_size))
    logger.log_info(f"Extracting features for {key}: {len(view)} images")

    feats, labels, indices = extract_image_features(session, batcher)
    if not (indices == np.arange(len(indices))).all():
        raise RuntimeError("Indexes should have consequent order")

    outs = None
    if save_outs:
        classes = cfg.prompting.classes or view.classes
        classifier = zeroshot_classifier(session.encode_text, classes, cfg.prompting.templates,
                                         device=session.device)
        outs = clip_logits(torch.from_numpy(feats).to(session.device), classifier, scale=1.0)
        outs = outs.cpu().numpy().astype(np.float32)

    store.save(key, features=feats, labels=labels, outs=outs,
               meta={"model": session.cfg.name, "dataset": str(cfg.dataset_name),
                     "count": int(len(feats))})
    logger.log_info({"type": "features_saved", "key": key, "count": int(len(feats))})


@C.main(config_path="../conf", config_name="save_features")
def run(cfg) -> None:
    logging.info("Start!")
    logger = make_logger(cfg.exp.project, cfg.exp.name, C.to_container(cfg))
    session = create_clip_session(cfg.clip.model_name, cfg.clip.get("checkpoint_path"),
                                  cfg.clip.get("dtype"),
                                  device=resolve_device(cfg.meta.get("device")),
                                  logger=logger, proj_path=cfg.clip.get("proj_path"),
                                  quant=cfg.clip.get("quant"))
    store = FeatureStore(cfg.store.root)
    model_tag = session.cfg.name.replace("/", "")
    if cfg.get("train_dataset") is not None:
        save_split_features(cfg, session, store, cfg.train_dataset,
                            f"{cfg.dataset_name}_train-{model_tag}",
                            bool(cfg.save_train_outs), logger)
    if cfg.get("test_dataset") is not None:
        save_split_features(cfg, session, store, cfg.test_dataset,
                            f"{cfg.dataset_name}_test-{model_tag}", False, logger)
    logging.info("Finish!")


if __name__ == "__main__":
    run()
