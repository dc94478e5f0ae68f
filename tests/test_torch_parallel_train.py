"""The training side of multi-device, the port against the JAX package on the CPU.

One gloo group of 4 CPU ranks (``parallel.launch``,
``tests/torch_parallel_ranks.train_rank``, started once for the file) runs
every multi-rank case; the JAX side runs in this process on the conftest's
virtual devices. Cases:

- the slicing rules: ``fsdp_spec`` (``tests/test_parallel.py``'s cases), and
  each rank's ``shard_params_tp`` (2 x 2), FSDP (data 4) and FSDP x TP (2 x 2)
  leaves against the JAX package's ``addressable_shards``, bit for bit (the
  JAX tree's qkv columns permuted as the port's are);
- the stacked layout: ``stack_block_params`` / ``unstack_block_params``
  against the JAX functions and round trips; the scan forwards (GPT2, and
  ClipGPT with a separate and a shared head adapter);
- GPipe on a ``('data', 'stage')`` 2 x 2 mesh: the forward at M = 1, 2, 4,
  its gradients (``wte`` included: it feeds the stem and the head), dp x pp,
  remat against no remat, and bf16 activations between the stages;
- TP: GPT-2's forward on each rank's slices;
- EP over 4 ranks: forward, gradients (experts, router, input) and every
  token served once; the ``MoEMLP`` module;
- ``dryrun_multichip``'s data-parallel adapter step;
- the ``train_gpt`` app in the group at dp = 4, tp = 2 (2 x 2), fsdp, fsdp +
  tp, pp = 2 (2 x 2) and scan_layers, from the JAX trainer's initial tree
  (``pretrained.model``): per-step losses, the first update's norm over every
  leaf and the adapters of the standard-layout step checkpoint against the
  JAX one-device trainer; a SIGTERM's flag on one rank stops every rank at
  the same micro-step; a tp = 2 ``train_full`` checkpoint resumed with its
  optimizer under tp = 2 and at one device; a JAX ``scan_layers`` step
  checkpoint resumed with its stacked optax state.

Tolerances (f32; the JAX package's own spread between layouts is 2e-3,
``tests/test_apps_e2e.py``): slices, shards and stacking bit for bit; the
forwards 1e-5 and gradients 2e-5 absolute (the JAX pipeline tests' 2e-4 /
2e-3); per-step losses 1e-5 relative, the first norm 1e-5 relative, the
adapters 2e-5 absolute (sums in another order, through three Adam updates).
Each measured value is printed beside its limit.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from tests import torch_parallel_ranks as R

ROOT = Path(__file__).resolve().parent.parent
CLIP_NORM = 0.5
CLIP_KW = dict(clip_vocab_size=300, clip_emb_dim=16, emb_hid_dim=16, head_hid_dim=16)
COMMON = ["clip_gpt.gpt_config=test-gpt", "clip_gpt.clip_emb_dim=16",
          "clip_gpt.adapters.emb_hid_dim=16", "clip_gpt.adapters.head_hid_dim=16",
          "data_loader.train.batch_size=4", "data_loader.val.batch_size=4",
          "training.epochs_num=1", "training.grad_accum_steps=2",
          f"training.clip_grad_norm={CLIP_NORM}", "training.evals_per_epoch=1",
          "training.info_steps=1", "training.bf16=false", "training.remat=true",
          "optim.adamw_kwargs.lr=0.01", "scheduler.warmup_part=0.2"]
LAYOUTS = {"dp": [], "tp": ["training.tp=2"],
           "fsdp": ["training.fsdp=true", "training.fsdp_min_elems=0"],
           "fsdp_tp": ["training.fsdp=true", "training.fsdp_min_elems=0", "training.tp=2"],
           "pp": ["training.pp=2"], "scan": ["training.scan_layers=true"]}
SCAN_ROWS = 20.5      # the JAX scan_layers run's 5 batches of 4
TOL_FWD, TOL_GRAD = 1e-5, 2e-5
TOL_LOSS_REL, TOL_NORM_REL, TOL_ADAPTER = 1e-5, 1e-5, 2e-5


class _Chdir:
    def __init__(self, path):
        self.path, self.old = path, None

    def __enter__(self):
        self.old = os.getcwd()
        os.chdir(self.path)

    def __exit__(self, *exc):
        os.chdir(self.old)


def _compose(package, overrides):
    if package == "summer_clip_tpu":
        from summer_clip_tpu.core import config as cfg_mod
    else:
        from summer_clip_torch.core import config as cfg_mod
    cfg = cfg_mod.compose(ROOT / package / "conf", "train_gpt", list(overrides))
    cfg.pop("hydra")
    return cfg


def _np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (str(k),))
        else:
            yield ".".join(prefix + (str(k),)), np.asarray(v)


def _jax_trainer(data, extra, run_dir):
    from summer_clip_tpu.apps.train_gpt import ClipGPTTrainer as JT

    run_dir.mkdir()
    with _Chdir(run_dir):
        jt = JT(_compose("summer_clip_tpu", COMMON + data + list(extra)))
        jt.setup()
        init = _np(jt.params)
        losses, step = [], jt._train_step

        def wrapped(params, opt_state, ids):
            out = step(params, opt_state, ids)
            losses.append(float(out[2]))
            return out

        jt._train_step = wrapped
        jt.train_loop()
    return jt, init, losses


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX one-device trainer's epoch (7 micro-steps, 3 clipped updates),
    its first update's norm over every leaf, and a short JAX ``scan_layers``
    run whose step checkpoint holds a stacked optax state."""
    import jax
    import jax.numpy as jnp

    from summer_clip_tpu.apps import tokenize_dataset as jtd
    from summer_clip_tpu.apps.train_gpt import lm_loss_fn
    from summer_clip_tpu.parallel import unstack_block_params

    root = tmp_path_factory.mktemp("parallel_train")
    with _Chdir(root):
        jtd.run(argv=["max_length=16", "source.n_docs=3", f"output_path={root}/c.npy",
                      "hydra.job.chdir=false"])
    n = len(np.load(root / "c.npy"))
    np.save(root / "v.npy", np.load(root / "c.npy")[:16])      # 4 eval batches
    data = [f"dataset.train.tokens_path={root}/c.npy", "dataset.train.subpart=0.28",
            f"dataset.val.tokens_path={root}/v.npy"]
    jt, init, losses = _jax_trainer(data, [], root / "jax")
    order = np.random.default_rng((int(jt.cfg.meta.random_state), 1)).permutation(
        len(jt.train_tokens))
    params = jax.tree_util.tree_map(jnp.asarray, init)

    def loss_of(p, ids):
        return lm_loss_fn(jt.model.apply({"params": p}, ids)["logits"], ids)

    grad_of = jax.jit(jax.grad(loss_of))
    grads = [grad_of(params, jnp.asarray(jt.train_tokens[order[i * 4:(i + 1) * 4]]))
             for i in range(2)]
    norm = float(np.sqrt(sum((((np.asarray(a) + np.asarray(b)) / 2).astype(np.float64) ** 2).sum()
                             for a, b in zip(jax.tree_util.tree_leaves(grads[0]),
                                             jax.tree_util.tree_leaves(grads[1])))))
    evals = [json.loads(line)["loss/eval"] for line in
             (root / "jax" / "records.jsonl").read_text().splitlines() if "loss/eval" in line]
    # scan_layers: 5 micro-steps (two updates, then one gradient in the accumulator)
    scan_data = data[:1] + [f"dataset.train.subpart={SCAN_ROWS / n}"] + data[2:]
    sj, sinit, _ = _jax_trainer(scan_data, ["training.scan_layers=true"], root / "jax_scan")
    assert len(sj.train_tokens) // 4 == 5
    sopt = _np(sj.opt_state)
    return {"root": root, "data": data, "init": init, "losses": losses, "norm": norm,
            "final": _np(jt.params), "eval": evals[-1], "scan_init": sinit,
            "scan_ckpt": root / "jax_scan" / "checkpoints" / "epoch_1" / "step_5",
            "scan_opt": sopt, "unstack": unstack_block_params}


@pytest.fixture(scope="module")
def init_ckpt(jax_side):
    """The JAX trainer's initial tree as a full port checkpoint and as a
    ``base`` file."""
    from summer_clip_torch.engine import checkpoint as ckpt
    from summer_clip_torch.models.gpt2 import from_flax_variables

    tree = from_flax_variables(jax_side["init"])
    ckpt.save_pytree(jax_side["root"] / "base.ckpt", tree)
    return ckpt.save_checkpoint(jax_side["root"] / "jax_init", params=tree)


def _jax_gpt(kind, head_hid=16):
    import jax

    from summer_clip_tpu.models import gpt2 as jg

    cfg = jg.GPT2_CONFIGS["test-gpt"]
    jm = jg.GPT2(cfg) if kind == "gpt2" else jg.ClipGPT(
        cfg, clip_vocab_size=300, clip_emb_dim=16, emb_hid_dim=16, head_hid_dim=head_hid)
    return jm, _np(jax.jit(jm.init)(jax.random.PRNGKey(0), np.zeros((1, 4), np.int32))["params"])


@pytest.fixture(scope="module")
def cases(jax_side, init_ckpt):
    import jax

    from summer_clip_tpu.methods.adapters import LinearClipAdapterFabric
    from summer_clip_tpu.parallel.ep import MoEMLP

    root, data = jax_side["root"], jax_side["data"]
    rng = np.random.RandomState(0)
    adapter = LinearClipAdapterFabric(output_dim=16).create_adapter(32)
    ad_params = _np(adapter.init(jax.random.PRNGKey(0), np.zeros((2, 32), np.float32),
                                 np.zeros((2, 32), np.float32))["params"])
    _, gpt = _jax_gpt("gpt2")
    moe = MoEMLP(num_experts=8, hidden_mult=2)
    x = rng.randn(4, 6, 16).astype(np.float32)
    moe_params = _np(moe.init(jax.random.PRNGKey(1), x)["params"])
    base = COMMON + data + ["meta.device=cpu"]
    apps = {name: base + extra + [f"pretrained.model={init_ckpt}",
                                  f"training.checkpoints_dir={root}/ckpt_{name}"]
            for name, extra in LAYOUTS.items()}
    apps["tp_full"] = base + ["training.tp=2", "clip_gpt.train_full=true",
                              f"training.checkpoints_dir={root}/ckpt_tp_full"]
    full_step = root / "ckpt_tp_full" / "epoch_1" / "step_7"
    return {"adapter": {"emb_dim": 32, "params": ad_params,
                        "feats": rng.randn(8, 32).astype(np.float32),
                        "text": rng.randn(8, 32).astype(np.float32)},
            "tree": _jax_gpt("clip_gpt")[1],
            "pp": {"tree": gpt, "ids": rng.randint(1, 512, (4, 12)),
                   "ids8": rng.randint(1, 512, (8, 12)),
                   "x": rng.randn(4, 12, 32).astype(np.float32)},
            "ep": {"params": moe_params, "x": x, "module": moe},
            "apps": apps,
            "preempt": base + [f"training.checkpoints_dir={root}/ckpt_preempt"],
            "resume": base + ["training.tp=2", "clip_gpt.train_full=true",
                              f"pretrained.model={full_step}", "pretrained.optimizer=true"],
            "full_step": full_step}


@pytest.fixture(scope="module")
def group(jax_side, cases):
    from summer_clip_torch.parallel import launch

    sent = {k: v for k, v in cases.items() if k != "full_step"}
    sent["ep"] = {k: v for k, v in cases["ep"].items() if k != "module"}
    return [r.value for r in launch(R.train_rank, ["cpu"] * 4, str(jax_side["root"]), sent)]


# --------------------------------------------------------------------------- #
# the slicing rules and the stacked layout
# --------------------------------------------------------------------------- #
class _Leaf:
    def __init__(self, *shape):
        self.shape = shape


@pytest.mark.parametrize("shape, base, min_elems, want", [
    ((64, 256), None, 0, (None, "data")), ((512, 32), None, 0, ("data", None)),
    ((64, 256), (None, "model"), 0, ("data", "model")),
    ((256, 64), ("model", None), 0, ("model", "data")),
    ((64,), None, 2 ** 14, ()), ((63, 1025), None, 0, ())])
def test_fsdp_spec_equals_the_jax_packages(shape, base, min_elems, want):
    from jax.sharding import PartitionSpec as P

    from summer_clip_tpu.parallel import fsdp_spec as jspec
    from summer_clip_torch.parallel import fsdp_spec

    got = fsdp_spec(_Leaf(*shape), 8, base=base, min_elems=min_elems)
    assert got == want
    assert P(*got) == jspec(_Leaf(*shape), 8, base=None if base is None else P(*base),
                            min_elems=min_elems)


def test_parallel_exports_the_jax_packages_names():
    import summer_clip_tpu.parallel as jpar

    import summer_clip_torch.parallel as par

    names = {n for n, v in vars(jpar).items()
             if not n.startswith("_") and getattr(v, "__module__", "").startswith("summer_clip_tpu")}
    assert len(names) >= 30
    assert names <= set(dir(par)), sorted(names - set(dir(par)))


def _permuted(params, tp_size):
    from summer_clip_tpu.parallel import permute_qkv_columns

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if "c_attn" in path and path[-1] == "kernel":
            return np.asarray(permute_qkv_columns(node, node.shape[0], tp_size))
        return node

    return walk(params, ())


@pytest.mark.parametrize("layout", ["tp", "fsdp", "fsdp_tp"])
def test_rank_leaves_are_the_jax_shards(group, cases, devices8, layout):
    from summer_clip_tpu.parallel import create_mesh, shard_params_fsdp, shard_params_tp

    params = cases["tree"]
    if layout == "tp":
        placed = shard_params_tp(_permuted(params, 2), create_mesh(2, 2, devices=devices8[:4]))
    elif layout == "fsdp":
        placed = shard_params_fsdp(params, create_mesh(4, 1, devices=devices8[:4]), min_elems=0)
    else:
        placed = shard_params_fsdp(_permuted(params, 2), create_mesh(2, 2, devices=devices8[:4]),
                                   with_tp=True, min_elems=0)
    import jax

    jleaves = dict(zip([".".join(str(k.key) for k in p) for p, _ in
                        jax.tree_util.tree_flatten_with_path(placed)[0]],
                       jax.tree_util.tree_leaves(placed)))
    cut = 0
    for r, value in enumerate(group):
        got = dict(_flat(value["shards"][layout]))
        assert set(got) == set(jleaves)
        for name, leaf in got.items():
            shard = next(s for s in jleaves[name].addressable_shards if s.device == devices8[r])
            np.testing.assert_array_equal(leaf, np.asarray(shard.data), err_msg=f"{name} {r}")
            cut += leaf.shape != jleaves[name].shape
    assert cut > 20


@pytest.mark.parametrize("n_stages", [1, 2])
def test_stack_and_unstack_equal_the_jax_packages(n_stages):
    from summer_clip_tpu.parallel import stack_block_params as jstack
    from summer_clip_torch.models.gpt2 import from_flax_variables
    from summer_clip_torch.parallel import stack_block_params, unstack_block_params

    params = _jax_gpt("clip_gpt")[1]
    jrest, jstacked = jstack(params, n_stages)
    rest, stacked = stack_block_params(from_flax_variables(params), n_stages)
    for (name, a), (_, b) in zip(_flat(_np(jstacked)), _flat({k: v for k, v in stacked.items()})):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert dict(_flat(_np(jrest))).keys() == dict(_flat(rest)).keys()
    back = dict(_flat(unstack_block_params(rest, stacked)))
    for name, leaf in _flat(params):
        np.testing.assert_array_equal(back[name], leaf, err_msg=name)


@pytest.mark.parametrize("kind, head_hid", [("gpt2", None), ("clip_gpt", 16), ("clip_gpt", None)])
def test_scan_forward_equals_the_jax_scan(kind, head_hid):
    import jax.numpy as jnp

    from summer_clip_tpu.parallel import scan_clip_gpt_forward as jscan_clip
    from summer_clip_tpu.parallel import scan_gpt2_forward as jscan_gpt2
    from summer_clip_tpu.parallel import stack_block_params as jstack
    from summer_clip_torch.models import gpt2 as tg
    from summer_clip_torch.parallel import (scan_clip_gpt_forward, scan_gpt2_forward,
                                            stack_block_params)

    jm, params = _jax_gpt(kind, head_hid)
    ids = np.random.RandomState(2).randint(1, 300, (3, 9))
    jrest, jstacked = jstack(params, 1)
    cfg = tg.GPT2_CONFIGS["test-gpt"]
    if kind == "gpt2":
        model = tg.GPT2(cfg, device="cpu")
        want = jscan_gpt2(jm, jrest, jstacked, jnp.asarray(ids))
    else:
        model = tg.ClipGPT(cfg, device="cpu", **{**CLIP_KW, "head_hid_dim": head_hid})
        want = jscan_clip(jm, jrest, jstacked, jnp.asarray(ids))
    model.load_tree(tg.from_flax_variables(params))
    rest, stacked = stack_block_params(model.tree(), 1)
    fwd = scan_gpt2_forward if kind == "gpt2" else scan_clip_gpt_forward
    for remat in (False, True):
        got = fwd(model, rest, stacked, torch.from_numpy(ids), remat=remat).numpy()
        err = float(np.abs(got - np.asarray(want)).max())
        print(f"scan {kind} head {head_hid} remat {remat}: max|d| {err:.2e} (tol {TOL_FWD})")
        assert err <= TOL_FWD
        np.testing.assert_array_equal(got, model(torch.from_numpy(ids))["logits"].numpy())


# --------------------------------------------------------------------------- #
# the pipeline, EP and the DP adapter step
# --------------------------------------------------------------------------- #
def _dense_pipeline(cases):
    import jax
    import jax.numpy as jnp

    from summer_clip_tpu.models import gpt2 as jg
    from summer_clip_tpu.parallel import stack_block_params as jstack

    jm = jg.GPT2(jg.GPT2_CONFIGS["test-gpt"])
    params = cases["pp"]["tree"]

    def loss(p, ids):
        return jnp.mean(jax.nn.logsumexp(jm.apply({"params": p}, ids)["logits"].astype(
            jnp.float32), -1))

    out = {}
    apply, grad = jax.jit(jm.apply), jax.jit(jax.grad(loss))
    for key in ("ids", "ids8"):
        ids = jnp.asarray(cases["pp"][key])
        out[key] = (np.asarray(apply({"params": params}, ids)["logits"]),
                    jstack(_np(grad(params, ids)), 2))
    return jm, out


def _close(got, want, tol, what):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    print(f"{what}: max|d| {err:.2e} (tol {tol})")
    assert err <= tol, what


def test_pipeline_forward_and_gradients_equal_the_dense_model(group, cases):
    _, dense = _dense_pipeline(cases)
    logits, (grest, gstacked) = dense["ids"]
    for r, value in enumerate(group):
        pp = value["pp"]
        stage = r % 2
        for m in (1, 2, 4):
            _close(pp["logits", m], logits, TOL_FWD, f"pp forward M={m} rank {r}")
        got = dict(_flat(pp["grads"]["stacked"]))
        for name, want in _flat(gstacked):
            _close(got[name][0], want[stage], TOL_GRAD, f"pp grad {name} rank {r}")
        rest = dict(_flat(pp["grads"]["rest"]))
        for name, want in _flat(grest):     # wte: the stem (stage 0) and the head (every stage)
            _close(rest[name], want, TOL_GRAD, f"pp grad {name} rank {r}")


def test_bf16_pipeline_equals_the_bf16_model(group):
    """bf16 activations move between the stages as bytes: the pipelined
    logits equal the one-device bf16 model's bit for bit."""
    for r, value in enumerate(group):
        got, want = value["pp"]["bf16"]
        np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")


def test_tp_gpt2_forward_equals_the_dense_model(group, cases):
    """GPT-2 on each rank's Megatron slices: the dense logits, and the dense
    gradient of the replicated (tied) ``wte`` on every rank."""
    _, dense = _dense_pipeline(cases)
    logits, (grest, _) = dense["ids"]
    for r, value in enumerate(group):
        _close(value["tp_gpt2"]["logits"], logits, TOL_FWD, f"tp gpt2 forward rank {r}")
        _close(value["tp_gpt2"]["wte"], grest["wte"]["embedding"], TOL_GRAD,
               f"tp gpt2 grad wte rank {r}")


def test_dp_pp_composition_equals_the_dense_model(group, cases):
    _, dense = _dense_pipeline(cases)
    logits, (grest, gstacked) = dense["ids8"]
    for r, value in enumerate(group):
        data, stage = r // 2, r % 2
        _close(value["pp"]["dp_pp_logits"], logits[data * 4:(data + 1) * 4], TOL_FWD,
               f"dp x pp forward rank {r}")
        got = dict(_flat(value["pp"]["dp_pp_grads"]["stacked"]))
        for name, want in _flat(gstacked):
            _close(got[name][0], want[stage], TOL_GRAD, f"dp x pp grad {name} rank {r}")
        _close(value["pp"]["dp_pp_grads"]["rest"]["wte"]["embedding"],
               grest["wte"]["embedding"], TOL_GRAD, f"dp x pp grad wte rank {r}")


def test_pipeline_remat_gives_the_same_gradients(group):
    for r, value in enumerate(group):
        a, b = dict(_flat(value["pp"]["remat", False])), dict(_flat(value["pp"]["remat", True]))
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], err_msg=f"{name} rank {r}")


def test_ep_equals_the_dense_moe(group, cases):
    import jax
    import jax.numpy as jnp

    moe, params, x = cases["ep"]["module"], cases["ep"]["params"], cases["ep"]["x"]
    y = np.asarray(jax.jit(moe.apply)({"params": params}, x))
    gp, gx = jax.jit(jax.grad(lambda p, xx: jnp.sum(moe.apply({"params": p}, xx) ** 2),
                              argnums=(0, 1)))(params, jnp.asarray(x))
    gp = _np(gp)
    for r, value in enumerate(group):
        ep = value["ep"]
        _close(ep["y"], y, TOL_FWD, f"ep forward rank {r}")
        _close(ep["x_grad"], gx, 1e-4, f"ep input grad rank {r}")
        _close(ep["grads"]["router"], gp["router"], 1e-4, f"ep router grad rank {r}")
        for k in ("w1", "b1", "w2", "b2"):
            _close(ep["grads"][k], gp[k][2 * r:2 * r + 2], 1e-4, f"ep {k} grad rank {r}")


def test_moe_module_equals_the_jax_module(cases):
    """The port's ``MoEMLP`` with the JAX module's parameters: the same
    forward (``moe_forward_dense``)."""
    import jax

    from summer_clip_torch.parallel import MoEMLP

    moe, params, x = cases["ep"]["module"], cases["ep"]["params"], cases["ep"]["x"]
    port = MoEMLP(16, 8, hidden_mult=2)
    assert {k: tuple(v.shape) for k, v in port.tree().items()} == \
        {k: v.shape for k, v in params.items()}
    with torch.no_grad():
        for k, v in port.tree().items():
            v.copy_(torch.from_numpy(params[k]))
        got = port(torch.from_numpy(x)).numpy()
    _close(got, np.asarray(jax.jit(moe.apply)({"params": params}, x)), TOL_FWD, "MoEMLP forward")


def test_every_token_is_served_once(cases):
    import jax.numpy as jnp

    from summer_clip_tpu.parallel.ep import _route as jroute
    from summer_clip_torch.parallel.ep import _route

    params, x = cases["ep"]["params"], cases["ep"]["x"].reshape(-1, 16)
    onehot, gate = _route({k: torch.from_numpy(np.array(v)) for k, v in params.items()},
                          torch.from_numpy(np.array(x)), torch.float32)
    np.testing.assert_array_equal(onehot.sum(1).numpy(), 1.0)
    assert (gate > 0).all()
    jonehot, jgate = jroute(params, jnp.asarray(x), jnp.float32)
    np.testing.assert_array_equal(onehot.numpy(), np.asarray(jonehot))
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), rtol=1e-6)


def test_dp_adapter_step_equals_the_jax_step(group, cases, devices8):
    """``dryrun_multichip``'s stage 1 on a data mesh of 4 virtual devices,
    against the port's 4 ranks: loss, averaged gradients, parameters after
    Adam."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from summer_clip_tpu.methods.adapters import LinearClipAdapterFabric
    from summer_clip_tpu.parallel import create_mesh

    c = cases["adapter"]
    adapter = LinearClipAdapterFabric(output_dim=16).create_adapter(32)
    mesh = create_mesh(data=4, model=1, devices=devices8[:4])
    dp = NamedSharding(mesh, P("data", None))
    feats, text = (jax.device_put(jnp.asarray(c[k]), dp) for k in ("feats", "text"))

    def loss_fn(p):
        li, lt = adapter.apply({"params": p}, feats, text)
        t = jnp.arange(li.shape[0])
        return (optax.softmax_cross_entropy_with_integer_labels(li, t).mean()
                + optax.softmax_cross_entropy_with_integer_labels(lt, t).mean()) / 2

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(c["params"])
    tx = optax.adam(1e-3)
    new = optax.apply_updates(c["params"], tx.update(grads, tx.init(c["params"]), c["params"])[0])
    from summer_clip_torch.methods.adapters import state_dict_from_tree

    want_g, want_p = state_dict_from_tree(_np(grads)), state_dict_from_tree(_np(new))
    for r, value in enumerate(group):
        got = value["dp_adapter"]
        assert abs(got["loss"] - float(loss)) <= 1e-6 * abs(float(loss)), r
        for n in want_g:
            _close(got["grads"][n], want_g[n], 1e-6, f"dp adapter grad {n} rank {r}")
            _close(got["params"][n], want_p[n], 1e-6, f"dp adapter param {n} rank {r}")


# --------------------------------------------------------------------------- #
# the train_gpt app in the group
# --------------------------------------------------------------------------- #
def _adapters(step_dir):
    from summer_clip_torch.engine.checkpoint import load_pytree

    return dict(_flat(_np_t(load_pytree(step_dir / "model.ckpt"))))


def _jflat(tree):
    """The array leaves of a JAX tree by dotted path (optax's masked nodes
    hold none)."""
    import jax

    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _np_t(tree):
    if isinstance(tree, dict):
        return {k: _np_t(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_layout_trains_as_the_jax_trainer(group, jax_side, layout):
    """Every rank's per-step losses (the global batch's), the first update's
    norm over every leaf, the step checkpoint's adapters (rank 0's, in the
    standard layout) and the eval loss against the JAX one-device trainer."""
    root = jax_side["root"]
    want = np.asarray(jax_side["losses"])
    for r, value in enumerate(group):
        run = value["apps"][layout]
        rel = float(np.abs(np.asarray(run["losses"]) - want).max() / np.abs(want).min())
        norm_rel = abs(run["norms"][0] - jax_side["norm"]) / jax_side["norm"]
        print(f"{layout} ({run['describe']}) rank {r}: losses {rel:.2e} (tol {TOL_LOSS_REL}), "
              f"first norm {norm_rel:.2e} (tol {TOL_NORM_REL}), {run['bytes']} parameter bytes")
        assert len(run["losses"]) == 7 and rel <= TOL_LOSS_REL
        assert norm_rel <= TOL_NORM_REL and run["norms"][0] > CLIP_NORM
    step = root / f"ckpt_{layout}" / "epoch_1" / "step_7"
    got = _adapters(step)
    final = dict(_flat(jax_side["final"]))
    assert set(got) == {n for n in final if n.startswith("adapter_")}
    for name, leaf in got.items():
        assert leaf.shape == final[name].shape
        _close(leaf, final[name], TOL_ADAPTER, f"{layout} adapter {name}")
    records = _records(group[0]["apps"][layout]["cwd"])
    evals = [rec["loss/eval"] for rec in records if rec.get("type") == "gpt_eval"]
    _close(evals[-1], jax_side["eval"], 1e-5 * jax_side["eval"], f"{layout} eval loss")
    if layout.startswith("fsdp"):   # a rank keeps about its share of the tree
        share = group[0]["apps"][layout]["bytes"] / group[0]["apps"]["dp"]["bytes"]
        print(f"{layout}: a rank holds {share:.3f} of the tree's bytes")
        assert share < (0.3 if layout == "fsdp" else 0.6)


def _records(run_root):
    path, = Path(run_root).rglob("records.jsonl")     # rank 0's run directory
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_sigterm_on_one_rank_stops_every_rank_at_one_step(group, jax_side):
    root = jax_side["root"]
    for value in group:
        assert len(value["preempt"]["losses"]) == 3
    step = root / "ckpt_preempt" / "epoch_1" / "step_3_preempt"
    assert (step / "optimizer.ckpt").exists() and (step / "model.ckpt").exists()
    records = _records(group[0]["preempt"]["cwd"])
    assert {"type": "preempted", "epoch": 1, "step": 3} in records


def _one_device_resume(argv):
    from summer_clip_torch.apps.train_gpt import ClipGPTTrainer
    from summer_clip_torch.engine.optim import named_state

    trainer = ClipGPTTrainer(_compose("summer_clip_torch", argv))
    trainer.setup()
    state = named_state(trainer.tx.state_dict(), trainer.tx, trainer.layout.names)
    return trainer, state


def test_tp_checkpoint_resumes_under_tp_and_on_one_device(group, cases, jax_side):
    """The tp = 2 ``train_full`` run's last step checkpoint (the standard
    layout, with its optimizer: 7 micro-steps, so the accumulator holds one
    gradient) resumed in the group under tp = 2 and here on one device: the
    same leaves and optimizer state, both equal to the files."""
    from summer_clip_torch.engine.checkpoint import load_pytree

    step = cases["full_step"]
    saved = dict(_flat(_np_t(load_pytree(step / "model.ckpt"))))
    assert len(saved) > 20 and "clip_emb" not in saved
    with _Chdir(jax_side["root"]):
        trainer, state = _one_device_resume([a for a in cases["resume"] if a != "training.tp=2"])
    assert (state["calls"], state["count"]) == (7, 3)
    shapes = {n: tuple(p.shape) for n, p in trainer.model.named_parameters()}
    for name, leaf in saved.items():
        assert leaf.shape == shapes[name], name       # the standard layout
        np.testing.assert_array_equal(dict(trainer.model.named_parameters())[name].detach(),
                                      leaf, err_msg=name)
    for r, value in enumerate(group):
        res = value["resumed"]
        assert res["counts"] == (7, 3), r
        for name, leaf in saved.items():
            np.testing.assert_array_equal(res["params"][name], leaf, err_msg=f"{name} {r}")
        assert set(res["moments"]) == set(state["moments"])
        for name, m in state["moments"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_array_equal(res["moments"][name][k], m[k].numpy(),
                                              err_msg=f"{name} {k} {r}")
        for name, a in state["acc"].items():
            np.testing.assert_array_equal(res["acc"][name], a.numpy(), err_msg=f"{name} {r}")


def test_jax_scan_layers_checkpoint_resumes_with_its_optimizer(jax_side, init_ckpt):
    """A JAX ``scan_layers`` step checkpoint: its optax state mirrors
    ``{"rest", "stacked"}`` (leaves ``(1, L, ...)``); the port resumes it on
    the standard names: counts, Adam's moments and the accumulator equal the
    JAX state's, unstacked."""
    from summer_clip_tpu.parallel import unstack_block_params

    root = jax_side["root"]
    scan_data = [a for a in jax_side["data"] if "subpart" not in a] + [
        f"dataset.train.subpart={SCAN_ROWS / len(np.load(root / 'c.npy'))}"]
    argv = COMMON + scan_data + ["meta.device=cpu", f"pretrained.model={jax_side['scan_ckpt']}",
                                 "pretrained.optimizer=true", f"+pretrained.base={root}/base.ckpt"]
    with _Chdir(root):
        _, state = _one_device_resume(argv)
    opt = jax_side["scan_opt"]
    acc = _jflat(unstack_block_params(opt.acc_grads["rest"], opt.acc_grads["stacked"]))
    assert (state["calls"], state["count"]) == (5, 2)
    assert set(state["acc"]) == set(acc) and len(acc) > 20
    for name, a in acc.items():
        np.testing.assert_array_equal(state["acc"][name].numpy(), a, err_msg=name)
    inner = opt.inner_opt_state[1].inner_states["decay"].inner_state[0]
    mu = _jflat(inner.mu["rest"])     # adapters only: every stacked leaf is masked
    moved = [n for n in state["moments"] if n in mu]
    assert moved and sorted(moved) == sorted(state["moments"])
    assert all(n.startswith("adapter_") for n in moved)
    for name in moved:
        np.testing.assert_array_equal(state["moments"][name]["exp_avg"].numpy(), mu[name],
                                      err_msg=name)
