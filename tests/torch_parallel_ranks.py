"""Rank functions of the multi-device CPU tests (``tests/test_torch_parallel_*.py``).

Each runs in one process of a gloo group that ``summer_clip_torch.parallel.launch``
starts, and is imported there by name: it imports nothing of JAX, and returns
numpy arrays and Python values, which the test process holds against the JAX
package and against the port's one-device runs.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch


def _app_dir(root: str, name: str) -> None:
    """Each rank runs an app in a directory of its own (rank 0's holds the
    records)."""
    import torch.distributed as dist

    sub = Path(root) / name / f"rank{dist.get_rank()}"
    sub.mkdir(parents=True, exist_ok=True)
    os.chdir(sub)


def cache_rank(root: str, case: dict) -> dict:
    """Meshes, the sharded and resident caches, data-parallel extraction
    (library and ``save_features``), and ``image_attention`` on 4 ranks."""
    from summer_clip_torch.apps import image_attention, save_features
    from summer_clip_torch.apps.common import ClipSession, extract_image_features
    from summer_clip_torch.data.datasets import SyntheticBatcher, SyntheticDataset
    from summer_clip_torch.models.clip import build_clip
    from summer_clip_torch.parallel import (ShardedResidentCache, create_mesh, replicate,
                                            shard_batch, sharded_cache_logits)

    out: dict = {}
    m22, m4, m14 = create_mesh(data=2, model=2), create_mesh(), create_mesh(data=1, model=4)
    out["meshes"] = [(m.shape, m.coords, sorted(a for a, g in m.groups.items() if g is not None))
                     for m in (m22, m4, m14)]
    out["shard"] = shard_batch(np.arange(32, dtype=np.float32).reshape(8, 4), m4)
    out["replicate"] = replicate({"w": np.ones(3)}, m4)["w"].numpy()

    for name, mesh in (("model4", m14), ("data2_model2", m22)):
        out["sharded", name] = sharded_cache_logits(case["f"], case["cache"], case["values"],
                                                    case["betas"], mesh).numpy()
    for cname in ("small", "many"):
        c = case["resident"][cname]
        res = ShardedResidentCache(c["cache"], c["outs"], m14)
        out["padded_rows", cname] = res.padded_rows
        for sel, inds in c["selections"].items():
            for kind in ("hard", "softmax"):
                out["resident", cname, sel, kind] = res.logits(
                    c["f"], inds, c["betas"], kind=kind, scale=c["scale"]).numpy()

    # data-parallel extraction through the library: 4 ranks against one device
    model, cfg = build_clip("test-vit", torch.Generator().manual_seed(5), device="cpu")
    ds = SyntheticDataset(num_classes=2, per_class=12, image_size=cfg.image_resolution)

    def batcher():
        return SyntheticBatcher(ds.test, batch_size=8, image_size=cfg.image_resolution)

    rendered, render = [], SyntheticDataset.render

    def counted(impath, size):   # the images this rank renders
        rendered.append(int(impath.rsplit("/", 1)[1]) + 6 * int(impath.split("/")[-2]))
        return render(impath, size)

    SyntheticDataset.render = staticmethod(counted)
    try:
        out["dp"] = extract_image_features(ClipSession(model, cfg, torch.device("cpu"), mesh=m4),
                                           batcher())
    finally:
        SyntheticDataset.render = staticmethod(render)
    out["rendered"] = sorted(rendered)
    out["one"] = extract_image_features(ClipSession(model, cfg, torch.device("cpu")), batcher())

    _app_dir(root, "save_features_w4")
    save_features.run(argv=case["save_features"] + [f"store.root={Path(root) / 'store_w4'}"])

    _app_dir(root, "image_attention")
    image_attention.run(argv=case["image_attention"])
    few_shot_apps(root, "w4", case)
    return out


def few_shot_apps(root: str, tag: str, case: dict) -> None:
    """``tip_adapter`` and ``train_prolip`` in the group: their extractions
    data parallel where the batch divides over the ranks."""
    from summer_clip_torch.apps import tip_adapter, train_prolip

    for name, app in (("tip_adapter", tip_adapter), ("train_prolip", train_prolip)):
        _app_dir(root, f"{name}_{tag}")
        app.run(argv=case[name])


def save_features_rank(root: str, argv: list, case: dict) -> None:
    """The one-device runs of the apps that ``cache_rank`` runs data parallel."""
    _app_dir(root, "save_features_w1")
    from summer_clip_torch.apps import save_features

    save_features.run(argv=argv + [f"store.root={Path(root) / 'store_w1'}"])
    few_shot_apps(root, "w1", case)


def _model(kind: str, config: str, tree):
    from summer_clip_torch.models import gpt2 as tg

    cfg = tg.GPT2_CONFIGS[config]
    clip_kw = dict(clip_vocab_size=300, clip_emb_dim=16, emb_hid_dim=24, head_hid_dim=24)
    m = tg.GPT2(cfg, device="cpu") if kind == "gpt2" else tg.ClipGPT(cfg, device="cpu", **clip_kw)
    m.load_tree(tg.from_flax_variables(tree))
    return m.eval()


def decode_cases(model, case: dict, mesh) -> dict:
    """The samplers and the engine on ``model`` (tensor-parallel over
    ``mesh``'s model axis, or one device with ``mesh=None``)."""
    from summer_clip_torch.apps import gen_gpt
    from summer_clip_torch.engine.serving import ContinuousBatcher

    quant = case["quant"]
    kw = dict(top_k=1, quant_int8=quant, mesh=mesh)
    out = {"device": gen_gpt.generate_device(model, case["prompt"], max_new_tokens=10, **kw),
           "batched": gen_gpt.generate_device_batched(model, case["prompts"], max_new_tokens=8,
                                                      eot_id=7, **kw),
           # a sampled run: every rank draws from its own generator, seeded alike
           "sampled": gen_gpt.generate_device(model, case["prompt"], max_new_tokens=10, top_k=20,
                                              quant_int8=quant, mesh=mesh,
                                              generator=torch.Generator().manual_seed(11))}
    if case.get("engine"):
        eng = ContinuousBatcher(model, batch_slots=2, max_len=48, greedy=True, quant_int8=quant,
                                mesh=mesh, burst=4, pipeline=2)
        reqs = [eng.submit(p, max_new_tokens=6) for p in case["engine"]]
        eng.run()
        out["engine"] = [r.out_ids for r in reqs]
    return out


def tp_rank(cases: dict) -> dict:
    """Every case at tp = 2 (a 2 x 2 mesh: two TP groups side by side) and, where
    the heads divide, at tp = 4."""
    from summer_clip_torch.parallel import create_mesh

    m22, m14 = create_mesh(data=2, model=2), create_mesh(data=1, model=4)
    out = {}
    for name, case in cases.items():
        model = _model(case["kind"], case["config"], case["tree"])   # int8 as the JAX tree is
        out[name, 2] = decode_cases(model, case, m22)
        if model.config.n_head % 4 == 0:
            out[name, 4] = decode_cases(model, case, m14)
    return out
