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


# ---------------------------------------------------------------------------
# the training side (tests/test_torch_parallel_train.py)
# ---------------------------------------------------------------------------
def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.detach().cpu().numpy()
            for k, v in tree.items()}


def _grad_tree(tree):
    return {k: _grad_tree(v) if isinstance(v, dict) else v.grad.detach().cpu().numpy()
            for k, v in tree.items()}


def _leaf_tree(tree):
    """Every tensor of ``tree`` a new leaf that requires grad."""
    return {k: _leaf_tree(v) if isinstance(v, dict) else v.detach().clone().requires_grad_(True)
            for k, v in tree.items()}


def dp_adapter_step(case: dict) -> dict:
    """``dryrun_multichip``'s stage 1 on 4 ranks: a linear adapter's
    contrastive step over the whole batch, its rows split over ``data``. The
    rank's adapter outputs are gathered (``axis_all_gather``, whose backward
    keeps the rank's part of the summed gradient); every rank computes the
    batch's loss, the gradients are averaged over ``data`` and Adam steps."""
    import torch.nn.functional as F

    from summer_clip_torch.engine.optim import adam
    from summer_clip_torch.methods.adapters import LinearClipAdapterFabric, state_dict_from_tree
    from summer_clip_torch.parallel import all_reduce, axis_all_gather, create_mesh, shard_batch

    mesh = create_mesh()
    adapter = LinearClipAdapterFabric(output_dim=16).create_adapter(case["emb_dim"])
    adapter.load_state_dict(state_dict_from_tree(case["params"]))
    feats, text = (torch.from_numpy(shard_batch(case[k], mesh)) for k in ("feats", "text"))
    img = F.normalize(adapter.image_adapter(feats), dim=-1)
    txt = F.normalize(adapter.text_adapter(text), dim=-1)
    img, txt = (axis_all_gather(t, mesh, "data") for t in (img, txt))
    li = adapter.logit_scale.exp() * img @ txt.t()
    targets = torch.arange(li.shape[0])
    loss = (F.cross_entropy(li, targets) + F.cross_entropy(li.t(), targets)) / 2
    loss.backward()
    for p in adapter.parameters():
        all_reduce(p.grad, mesh, "data").div_(mesh.size("data"))
    grads = {n: p.grad.clone().numpy() for n, p in adapter.named_parameters()}
    tx = adam(dict(adapter.named_parameters()), 1e-3)
    tx.step()
    return {"loss": float(loss), "grads": grads,
            "params": {n: p.detach().numpy() for n, p in adapter.named_parameters()}}


def layout_shards(tree: dict) -> dict:
    """This rank's ``shard_params_tp`` (2 x 2), FSDP (data 4) and FSDP x TP
    (2 x 2) leaves of a whole ClipGPT tree, ``min_elems=0``."""
    from summer_clip_torch.models import gpt2 as tg
    from summer_clip_torch.parallel import create_mesh, shard_params_fsdp, shard_params_tp

    full = tg.from_flax_variables(tree)
    m22, m4 = create_mesh(data=2, model=2), create_mesh()
    return {"tp": _numpy_tree(shard_params_tp(full, m22)),
            "fsdp": _numpy_tree(shard_params_fsdp(full, m4, min_elems=0)),
            "fsdp_tp": _numpy_tree(shard_params_fsdp(full, m22, with_tp=True, min_elems=0))}


def tp_gpt2_case(case: dict) -> dict:
    """GPT-2's forward on each rank's Megatron slices (2 x 2 mesh) and the
    gradient of ``mean(logsumexp(logits))`` for its replicated ``wte``."""
    from summer_clip_torch.models import gpt2 as tg
    from summer_clip_torch.parallel import create_mesh, shard_params_tp
    from summer_clip_torch.parallel.tp import install_leaves, tp_gpt2_forward

    mesh = create_mesh(data=2, model=2)
    model = tg.GPT2(tg.GPT2_CONFIGS["test-gpt"], device="cpu")
    install_leaves(model, shard_params_tp(tg.from_flax_variables(case["tree"]), mesh))
    model.requires_grad_(True)
    logits = tp_gpt2_forward(model, torch.from_numpy(case["ids"]), mesh)
    _mean_logsumexp(logits).backward()
    return {"logits": logits.detach().numpy(), "wte": model.wte.embedding.grad.numpy()}


def _mean_logsumexp(logits):
    return torch.logsumexp(logits.float(), -1).mean()


def pipeline_cases(case: dict) -> dict:
    """GPipe on a ``('data', 'stage')`` 2 x 2 mesh at test-gpt: the forward
    with the whole batch on every data row at M = 1, 2, 4 and its gradients at
    M = 2; dp x pp (rows over ``data``, M = 2, gradients averaged over
    ``data``); the staged stack alone with and without remat."""
    import torch.distributed as dist

    from summer_clip_torch.models import gpt2 as tg
    from summer_clip_torch.parallel import (create_mesh, pipeline_blocks, pp_gpt2_forward,
                                            shard_batch, shard_stacked_pp, stack_block_params)

    mesh = create_mesh(axes={"data": 2, "stage": 2})
    model = tg.GPT2(tg.GPT2_CONFIGS["test-gpt"], device="cpu")
    full = tg.from_flax_variables(case["tree"])
    out = {}
    ids = torch.from_numpy(case["ids"])

    def run(ids, m, data_axis=None):
        rest, stacked = stack_block_params(full, 2)
        rest, local = _leaf_tree(rest), _leaf_tree(shard_stacked_pp(stacked, mesh))
        logits = pp_gpt2_forward(model, rest, local, ids, mesh, n_microbatches=m,
                                 data_axis=data_axis)
        _mean_logsumexp(logits).backward()
        grads = {"rest": rest, "stacked": local}
        if data_axis:
            for t in _tensors(grads):
                dist.all_reduce(t.grad, group=mesh.groups["data"])
                t.grad /= mesh.size("data")
        return logits.detach().numpy(), _grad_tree(grads)

    for m in (1, 2, 4):
        out["logits", m], grads = run(ids, m)
        if m == 2:
            out["grads"] = grads
    out["dp_pp_logits"], out["dp_pp_grads"] = run(
        shard_batch(torch.from_numpy(case["ids8"]), mesh), 2, "data")
    bf16 = tg.GPT2(tg.GPT2_CONFIGS["test-gpt"], dtype=torch.bfloat16, device="cpu").load_tree(full)
    rest, stacked = stack_block_params(full, 2)
    with torch.no_grad():   # bf16 activations cross the stages (as bytes)
        out["bf16"] = (pp_gpt2_forward(bf16, rest, shard_stacked_pp(stacked, mesh), ids, mesh,
                                       n_microbatches=2).numpy(),
                       bf16(ids)["logits"].numpy())
    x = torch.from_numpy(case["x"])
    for remat in (False, True):
        _, stacked = stack_block_params(full, 2)
        local = _leaf_tree(shard_stacked_pp(stacked, mesh))
        y = pipeline_blocks(local, x, mesh, num_heads=2, n_microbatches=2, remat=remat)
        (y.float() ** 2).sum().backward()
        out["remat", remat] = _grad_tree(local)
    return out


def _tensors(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tensors(v)
        else:
            yield v


def ep_case(case: dict) -> dict:
    """The EP forward over 4 ranks (2 of 8 experts each) and the gradients of
    ``sum(y ** 2)``: the rank's experts, the router and the input."""
    from summer_clip_torch.parallel import create_mesh, moe_apply_ep, shard_experts_ep

    mesh = create_mesh(axes={"expert": 4})
    whole = {k: torch.from_numpy(v) for k, v in case["params"].items()}
    local = _leaf_tree(shard_experts_ep(whole, mesh))
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    y = moe_apply_ep(local, x, mesh)
    (y ** 2).sum().backward()
    return {"y": y.detach().numpy(), "grads": _grad_tree(local), "x_grad": x.grad.numpy()}


def _recording_run(root: str, name: str, argv: list, stop_at: int = 0) -> dict:
    """``train_gpt.run`` in the group, each micro-step's loss and each
    update's norm recorded; ``stop_at`` > 0: this rank alone gets a SIGTERM
    just before that micro-step."""
    import signal

    from summer_clip_torch.apps import train_gpt

    cls = train_gpt.ClipGPTTrainer
    losses, norms = [], []
    step = cls.train_step

    def recorded(self, ids):
        if len(losses) + 1 == stop_at:
            os.kill(os.getpid(), signal.SIGTERM)    # the trainer's guard catches it
        count = self.tx.count
        loss = step(self, ids)
        losses.append(loss)
        if self.tx.count != count:
            norms.append(self.tx.inner.last_grad_norm)
        return loss

    _app_dir(root, name)
    cls.train_step = recorded
    try:
        trainer = train_gpt.run(argv=argv)
    finally:
        cls.train_step = step
    return {"losses": losses, "norms": norms, "describe": trainer.layout.describe,
            "bytes": sum(p.numel() * p.element_size() for p in trainer.model.parameters()),
            "cwd": os.getcwd()}


def resumed_state(root: str, argv: list) -> dict:
    """A trainer set up in the group from ``pretrained.model`` and
    ``pretrained.optimizer``: its leaves and optimizer state gathered whole."""
    from summer_clip_torch.apps import train_gpt
    from summer_clip_torch.core import config as C
    from summer_clip_torch.engine.optim import named_state

    conf = Path(train_gpt.__file__).resolve().parent.parent / "conf"
    cfg = C.compose(conf, "train_gpt", argv)
    cfg.pop("hydra")
    _app_dir(root, "resumed")
    trainer = train_gpt.ClipGPTTrainer(cfg)
    trainer.setup()
    lay = trainer.layout
    params = lay.gather_named({n: p.detach() for n, p in trainer.model.named_parameters()})
    state = lay.gather_state(named_state(trainer.tx.state_dict(), trainer.tx, lay.names))
    return {"params": {n: t.numpy() for n, t in params.items()},
            "moments": {n: {k: v.numpy() for k, v in m.items()} for n, m in state["moments"].items()},
            "acc": None if state["acc"] is None else {n: t.numpy() for n, t in state["acc"].items()},
            "counts": (state["calls"], state["count"])}


def train_rank(root: str, case: dict) -> dict:
    """Every training-side case on 4 CPU ranks, in one group."""
    out = {"dp_adapter": dp_adapter_step(case["adapter"]), "shards": layout_shards(case["tree"]),
           "pp": pipeline_cases(case["pp"]), "tp_gpt2": tp_gpt2_case(case["pp"]),
           "ep": ep_case(case["ep"]), "apps": {}}
    for name, argv in case["apps"].items():
        out["apps"][name] = _recording_run(root, name, argv)
    out["preempt"] = _recording_run(root, "preempt", case["preempt"],
                                    stop_at=3 if torch.distributed.get_rank() == 2 else 0)
    torch.distributed.barrier()     # rank 0 has written its checkpoints
    out["resumed"] = resumed_state(root, case["resume"])
    return out
