"""Zero-shot CLIP evaluation over cached image features.

Counterpart of ``summer_clip_tpu/apps/eval_clip.py``, composed from the port's
own copy of its config (``summer_clip_torch/conf``): load stored features, build the prompt-ensemble classifier through
the text tower, report acc@1/acc@5 as a ``zero_shot`` record.

Run: ``python -m summer_clip_torch.apps.eval_clip eval.features_key=<key>``.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from summer_clip_torch.apps.common import create_clip_session
from summer_clip_torch.apps.features_io import resolve_features
from summer_clip_torch.core import config as C
from summer_clip_torch.engine.trainer import make_logger, resolve_device, set_random_state
from summer_clip_torch.methods.zeroshot import clip_logits, compute_accuracy, zeroshot_classifier
from summer_clip_torch.store import FeatureStore


def eval_clip(cfg, logger) -> dict:
    set_random_state(int(cfg.meta.random_state))
    session = create_clip_session(cfg.clip.model_name, cfg.clip.get("checkpoint_path"),
                                  cfg.clip.get("dtype"),
                                  device=resolve_device(cfg.meta.get("device")),
                                  logger=logger, quant=cfg.clip.get("quant"))
    view = C.instantiate(cfg.dataset)
    store = FeatureStore(cfg.store.root) if cfg.get("store") else None

    classes = cfg.prompting.classes or view.classes
    classifier = zeroshot_classifier(session.encode_text, classes, cfg.prompting.templates,
                                     device=session.device)
    feats = torch.from_numpy(np.array(resolve_features(cfg.eval, store))).to(session.device)
    logits = clip_logits(feats, classifier)
    top1, top5 = compute_accuracy(logits, view.labels())
    logger.log_info({"type": "zero_shot", "acc1": top1, "acc5": top5})
    logging.info(f"acc@1: {top1}")
    logging.info(f"acc@5: {top5}")
    return {"acc1": top1, "acc5": top5}


@C.main(config_path="../conf", config_name="eval_clip")
def run(cfg) -> None:
    logging.info("Start!")
    logger = make_logger(cfg.exp.project, cfg.exp.name, C.to_container(cfg))
    eval_clip(cfg, logger)
    logging.info("Finish!")


if __name__ == "__main__":
    run()
