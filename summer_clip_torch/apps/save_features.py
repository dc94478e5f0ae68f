"""Feature-extraction app: stream train+test splits through the frozen image
tower once and persist the features for every downstream method.

Counterpart of ``summer_clip_tpu/apps/save_features.py``, composed from the
port's copy of its config (``summer_clip_torch/conf/save_features.yaml``). Features land in the
:class:`FeatureStore` under the same catalog keys
``<dataset>_{train,test}-<model>`` with the same (N, D) row layout, so either
package reads what the other wrote.

An eval split of JPEG files decodes through the native library
(:mod:`summer_clip_torch.native`) where it builds, as in the JAX app.

Run: ``python -m summer_clip_torch.apps.save_features dataset_name=sun397``.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from summer_clip_torch.apps.common import (create_clip_session, data_parallel_mesh,
                                           data_parallel_world, extract_image_features)
from summer_clip_torch.core import config as C
from summer_clip_torch.engine.trainer import make_logger, resolve_device
from summer_clip_torch.parallel import mesh as M
from summer_clip_torch.methods.zeroshot import clip_logits, zeroshot_classifier
from summer_clip_torch.store import FeatureStore


def save_split_features(cfg, session, store: FeatureStore, dataset_cfg, key: str,
                        save_outs: bool, logger) -> None:
    view = C.instantiate(dataset_cfg)
    view.transform.input_size = session.input_size
    if hasattr(view.transform, "device_normalize"):
        # ship raw uint8 to the device; normalization runs there
        view.transform.device_normalize = bool(cfg.data.get("device_normalize", False))
    # native rows are normalized float32 on the host whatever device_normalize says
    batcher = view.batcher(batch_size=int(cfg.data.batch_size))
    logger.log_info(f"Extracting features for {key}: {len(view)} images")

    feats, labels, indices = extract_image_features(session, batcher)
    if not (indices == np.arange(len(indices))).all():
        raise RuntimeError("Indexes should have consequent order")
    if not M.leads():
        return   # rank 0 writes the store

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


def _extract(cfg) -> None:
    logging.info("Start!")
    logger = make_logger(cfg.exp.project, cfg.exp.name, C.to_container(cfg))
    mesh = data_parallel_mesh(int(cfg.data.batch_size))
    if mesh is not None:
        logger.log_info(f"Sharding extraction batches over {mesh.shape['data']} ranks")
    session = create_clip_session(cfg.clip.model_name, cfg.clip.get("checkpoint_path"),
                                  cfg.clip.get("dtype"),
                                  device=resolve_device(cfg.meta.get("device")),
                                  logger=logger, proj_path=cfg.clip.get("proj_path"),
                                  quant=cfg.clip.get("quant"), mesh=mesh)
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


@C.main(config_path="../conf", config_name="save_features")
def run(cfg):
    """One process, or one a rank (``data_parallel_world``) unless a process
    group exists; returns each rank's ``parallel.mesh.RankResult`` then."""
    if not M.distributed_init():
        world = data_parallel_world(cfg, int(cfg.data.batch_size))
        if world > 1:
            return M.launch(_extract, M.rank_devices(resolve_device(cfg.meta.get("device")), world),
                            cfg)
    return _extract(cfg)


if __name__ == "__main__":
    run()
