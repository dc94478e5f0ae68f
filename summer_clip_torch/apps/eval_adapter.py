"""Adapter evaluation: rebuild from a train checkpoint's meta, score the test split.

Counterpart of ``summer_clip_tpu/apps/eval_adapter.py``: the training
configuration comes from the checkpoint's ``meta.yaml`` (written by the port's
``train_adapter``), the adapter fabric is rebuilt and its parameters loaded,
and acc@1/5 of adapter-encoded features against the prompt-ensemble
classifier go into an ``eval_adapter`` record. A checkpoint the JAX package
wrote (msgpack) is not readable here.

Run: ``python -m summer_clip_torch.apps.eval_adapter eval.checkpoint_dir=<dir>
eval.features_key=<key>``.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn.functional as F

from summer_clip_torch.apps.common import create_clip_session
from summer_clip_torch.apps.features_io import resolve_features
from summer_clip_torch.core import config as C
from summer_clip_torch.engine import checkpoint as ckpt
from summer_clip_torch.engine.trainer import make_logger, resolve_device, set_random_state
from summer_clip_torch.methods.zeroshot import compute_accuracy, zeroshot_classifier
from summer_clip_torch.store import FeatureStore


def eval_adapter(cfg, logger) -> dict:
    set_random_state(int(cfg.meta.random_state))
    device = resolve_device(cfg.meta.get("device"))
    loaded = ckpt.load_checkpoint(cfg.eval.checkpoint_dir)
    meta = loaded.get("meta") or {}
    adapter_cfg = meta.get("adapter") or C.to_container(cfg.get("adapter") or {}, resolve=True)
    clip_cfg = meta.get("clip") or C.to_container(cfg.clip, resolve=True)
    prompting = meta.get("prompting") or C.to_container(cfg.prompting, resolve=True)

    view = C.instantiate(cfg.dataset)
    store = FeatureStore(cfg.store.root) if cfg.get("store") else None
    features = torch.from_numpy(np.array(resolve_features(cfg.eval, store), np.float32)).to(device)

    session = create_clip_session(clip_cfg["model_name"], clip_cfg.get("checkpoint_path"),
                                  clip_cfg.get("dtype"), device=device, logger=logger,
                                  quant=clip_cfg.get("quant"))
    classes = prompting.get("classes") or view.classes
    text_features = zeroshot_classifier(session.encode_text, classes, prompting["templates"],
                                        device=device).float()

    fabric = C.instantiate(adapter_cfg)
    adapter = fabric.create_adapter(int(meta.get("emb_dim", features.shape[1])))
    adapter.load_state_dict(loaded["params"])
    adapter.to(device).eval()
    with torch.no_grad():
        feats = F.normalize(adapter.encode(features), dim=-1)
        logits = 100.0 * feats @ text_features.t()
    top1, top5 = compute_accuracy(logits, view.labels())
    logging.info(f"acc@1: {top1}")
    logging.info(f"acc@5: {top5}")
    logger.log_info({"type": "eval_adapter", "acc1": top1, "acc5": top5})
    return {"acc1": top1, "acc5": top5}


@C.main(config_path="../conf", config_name="eval_adapter")
def run(cfg) -> None:
    logging.info("Start!")
    logger = make_logger(cfg.exp.project, cfg.exp.name, C.to_container(cfg))
    eval_adapter(cfg, logger)
    logging.info("Finish!")


if __name__ == "__main__":
    run()
