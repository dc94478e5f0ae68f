"""The port reads the JAX package's checkpoints (``engine/checkpoint``).

- The msgpack decoder against ``flax.serialization`` on synthetic trees: every
  dtype the port reads (``bfloat16`` included), 0-d arrays, numpy scalars,
  complex numbers, strings, integers at every msgpack width, nested empty maps
  and chunked arrays (``MAX_CHUNK_SIZE`` lowered in both packages), bit for
  bit; the port's encoder writes flax's bytes; the reader runs where
  ``msgpack``, ``flax``, ``jax`` and ``ml_dtypes`` cannot be imported.
- Real JAX checkpoints at test size: a ``train_adapter`` directory read by the
  port's ``eval_adapter`` (the accuracy of the JAX ``eval_adapter``, the
  adapter's features within the adapter tests' 1e-4); a ``train_gpt`` run
  resumed in the port from the JAX step checkpoint and its optax state (the
  losses of the JAX run's next two updates within 2e-6 relative, the adapters
  and Adam's moments within 2e-5, as ``tests/test_torch_train_gpt.py``); its
  step checkpoint through ``gen_gpt.load_pretrained_clip_gpt`` with ``base``
  (the JAX logits within 1e-4) and without (it raises, naming the leaves).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as fs

from summer_clip_torch.engine import checkpoint as C

ROOT = Path(__file__).resolve().parent.parent
DTYPES = ["float32", "bfloat16", "float16", "float64", "int8", "int16", "int32", "int64",
          "uint8", "uint16", "uint32", "uint64", "bool", "complex64", "complex128"]


def _np_dtype(name):
    return jnp.bfloat16 if name == "bfloat16" else np.dtype(name)


def _arrays(name, seed=0):
    """0-d, 1-d, 2-d and empty arrays of ``name`` and a numpy scalar."""
    rng = np.random.default_rng(seed)
    dt = _np_dtype(name)

    def draw(shape):
        x = rng.standard_normal(shape) * 100
        if name == "bool":
            return x > 0
        if name.startswith("complex"):
            return (x + 1j * rng.standard_normal(shape)).astype(dt)
        if name.startswith(("int", "uint")):
            info = np.iinfo(dt)
            return rng.integers(info.min, info.max, shape, dtype=dt, endpoint=True)
        return np.asarray(x, dt)

    return {"zero_d": draw(()), "row": draw((5,)), "matrix": draw((3, 4)),
            "empty": draw((0, 2)), "scalar": draw((1,))[0]}


def _same(got, want, path="tree"):
    """``got`` (the port's restore) equals flax's ``want`` bit for bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (np.ndarray, np.generic)):
        want = np.asarray(want)
        assert isinstance(got, torch.Tensor), path
        assert tuple(got.shape) == want.shape, path
        assert C._DTYPE_NAMES[got.dtype] == want.dtype.name, (path, got.dtype, want.dtype)
        assert got.reshape(-1).view(torch.uint8).numpy().tobytes() == want.tobytes(), path
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decoder_reads_flax_arrays_bit_for_bit(dtype):
    tree = {"params": _arrays(dtype), "other": {"w": _arrays(dtype, seed=1)["matrix"]}}
    data = fs.to_bytes(tree)
    _same(C.msgpack_restore(data), fs.msgpack_restore(data))
    assert C.msgpack_serialize(tree) == data


INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
        -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63]


@pytest.mark.parametrize("value", INTS)
def test_ints_at_every_msgpack_width(value):
    data = fs.to_bytes({"v": value, "neg": -value if value <= 2 ** 63 else 0})
    assert C.msgpack_restore(data) == fs.msgpack_restore(data)
    assert C.msgpack_serialize({"v": value, "neg": -value if value <= 2 ** 63 else 0}) == data


@pytest.mark.parametrize("length", [0, 31, 32, 255, 256, 65535, 65536])
def test_strings_and_bytes_at_every_length(length):
    tree = {"s": "é" * (length // 2) + "x" * (length % 2), "b": b"\x07" * length,
            "k" * max(length // 300, 1): length}
    data = fs.to_bytes(tree)
    _same(C.msgpack_restore(data), fs.msgpack_restore(data))
    assert C.msgpack_serialize(tree) == data


def test_scalars_complex_none_floats_and_empty_maps():
    tree = {"none": None, "t": True, "f": False, "pi": 3.141592653589793, "tiny": -2.5e-300,
            "c": complex(1.5, -2.0), "np_c": np.complex64(1 - 2j), "np_f": np.float64(0.1),
            "np_i": np.int32(-7), "np_b": np.bool_(True),
            "masked": {}, "nested": {"a": {}, "b": {"c": {}, "d": np.zeros((0,), np.float32)}},
            "wide": {str(i): i for i in range(70000)}}
    data = fs.to_bytes(tree)
    got = C.msgpack_restore(data)
    _same(got, fs.msgpack_restore(data))
    assert got["masked"] == {} and got["nested"]["b"]["c"] == {}
    assert C.msgpack_serialize(tree) == data
    # a list round-trips as an array (msgpack_serialize of a raw tree)
    raw = fs.msgpack_serialize({"l": [1, "a", np.ones(2, np.float32)]}, in_place=True)
    _same(C.msgpack_restore(raw), fs.msgpack_restore(raw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_chunked_arrays(dtype, monkeypatch):
    """flax splits an array of more than ``MAX_CHUNK_SIZE`` bytes into chunks
    (lowered to 64 bytes here in both packages)."""
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(C, "MAX_CHUNK_SIZE", 64)
    arrays = _arrays(dtype, seed=3)
    tree = {"big": np.concatenate([arrays["matrix"].reshape(-1)] * 9).reshape(6, 18),
            "small": arrays["row"], "inner": {"big": arrays["matrix"]}}
    data = fs.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    _same(C.msgpack_restore(data), fs.msgpack_restore(data))
    assert C.msgpack_serialize(tree) == data
    port = {k: torch.from_numpy(np.array(v).view(np.int16)).view(torch.bfloat16)
            if dtype == "bfloat16" else torch.from_numpy(np.array(v))
            for k, v in tree.items() if k != "inner"}
    assert C.msgpack_serialize(port) == fs.to_bytes({k: tree[k] for k in port})


def test_encoder_round_trips_through_flax(tmp_path):
    tree = {"w": torch.randn(3, 4), "h": torch.randn(5, dtype=torch.bfloat16),
            "i": torch.arange(4, dtype=torch.int8), "n": torch.tensor(3), "m": {}}
    C.save_pytree(tmp_path / "t.msgpack", tree, format="msgpack")
    back = fs.msgpack_restore((tmp_path / "t.msgpack").read_bytes())
    for k in ("w", "i", "n"):
        np.testing.assert_array_equal(np.asarray(back[k]), tree[k].numpy())
    assert np.asarray(back["h"]).view(np.int16).tolist() == tree["h"].view(torch.int16).tolist()
    assert back["m"] == {}
    again = C.load_pytree(tmp_path / "t.msgpack")
    assert all(torch.equal(again[k], tree[k]) for k in ("w", "h", "i", "n"))


def test_load_pytree_tells_the_formats_apart(tmp_path):
    tree = {"a": {"b": torch.randn(2, 3)}, "c": torch.arange(3)}
    C.save_pytree(tmp_path / "t.pt", tree)
    got = C.load_pytree(tmp_path / "t.pt")
    assert torch.equal(got["a"]["b"], tree["a"]["b"]) and torch.equal(got["c"], tree["c"])
    (tmp_path / "bad").write_bytes(b"\x93\x01\x02\x03")
    with pytest.raises(ValueError, match="bad"):
        C.load_pytree(tmp_path / "bad")
    with pytest.raises(ValueError, match="format"):
        C.save_pytree(tmp_path / "x", tree, format="npz")


_BLOCKED_READ = """
import hashlib, json, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('msgpack', 'flax', 'jax', 'jaxlib', 'ml_dtypes', 'optax'):
            raise ImportError('blocked: ' + name)
        return None
sys.meta_path.insert(0, Block())
from summer_clip_torch.engine import checkpoint as C
import torch
out = {}
def walk(node, path):
    if isinstance(node, dict):
        for k, v in node.items():
            walk(v, path + '/' + k)
    else:
        out[path] = [str(node.dtype), list(node.shape),
                     hashlib.sha256(node.reshape(-1).view(torch.uint8).numpy().tobytes()).hexdigest()]
walk(C.load_pytree(sys.argv[1]), '')
print(json.dumps(out))
"""


def test_reader_needs_no_msgpack_flax_jax_or_ml_dtypes(tmp_path):
    import hashlib

    tree = {name: _arrays(name)["matrix"] for name in ("float32", "bfloat16", "int8", "uint32")}
    (tmp_path / "t.msgpack").write_bytes(fs.to_bytes(tree))
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_READ, str(tmp_path / "t.msgpack")],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.splitlines()[-1])
    for name, a in tree.items():
        dt, shape, digest = got["/" + name]
        assert dt == f"torch.{name}" and shape == list(a.shape)
        assert digest == hashlib.sha256(np.asarray(a).tobytes()).hexdigest()


def test_jax_targets_in_meta_become_the_ports(tmp_path):
    (tmp_path / "meta.yaml").write_text(
        "adapter:\n  _target_: summer_clip_tpu.methods.adapters.LinearClipAdapterFabric\n"
        "  output_dim: null\nnote: summer_clip_tpu.x stays\n")
    meta = C.load_checkpoint(tmp_path)["meta"]
    assert meta["adapter"]["_target_"] == "summer_clip_torch.methods.adapters.LinearClipAdapterFabric"
    assert meta["note"] == "summer_clip_tpu.x stays"


# ---------------------------------------------------------------------------
# optax state
# ---------------------------------------------------------------------------
def _optax_pair(accum: int, clip: bool):
    """An optax ``[MultiSteps](chain(clip, multi_transform))`` as JAX
    train_gpt builds it over a small tree, and the port's optimizer over the
    same named leaves."""
    import optax

    from summer_clip_torch.engine import optim as O

    rng = np.random.default_rng(0)
    params = {"a": {"kernel": rng.standard_normal((3, 4)).astype(np.float32),
                    "bias": rng.standard_normal(4).astype(np.float32)},
              "frozen": rng.standard_normal(5).astype(np.float32)}
    labels = {"a": {"kernel": "decay", "bias": "no_decay"}, "frozen": "freeze"}
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 10)
    tx = optax.multi_transform({"decay": optax.adamw(sched, weight_decay=0.1),
                                "no_decay": optax.adamw(sched, weight_decay=0.0),
                                "freeze": optax.set_to_zero()}, labels)
    if clip:
        tx = optax.chain(optax.clip_by_global_norm(0.5), tx)
    if accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accum)
    named = {"a.kernel": torch.from_numpy(params["a"]["kernel"].copy()).requires_grad_(True),
             "a.bias": torch.from_numpy(params["a"]["bias"].copy()).requires_grad_(True),
             "frozen": torch.from_numpy(params["frozen"].copy()).requires_grad_(True)}
    trainable = {k: v for k, v in named.items() if k != "frozen"}
    port = O.with_grad_accum(O.adamw(trainable, sched, weight_decay=0.1,
                                     mask=O.decay_mask(trainable),
                                     grad_clip_norm=0.5 if clip else None,
                                     frozen=[named["frozen"]]), accum)
    return params, tx, named, port


@pytest.mark.parametrize("accum,clip,steps", [(2, True, 5), (2, True, 4), (1, True, 3),
                                              (3, False, 4), (1, False, 2)])
def test_optax_state_resumes_in_the_port(accum, clip, steps):
    """After ``steps`` calls in optax, the converted state resumes in the
    port's optimizer: the next calls move the leaves as optax moves them."""
    import optax

    params, tx, named, port = _optax_pair(accum, clip)
    state = tx.init(params)
    rng = np.random.default_rng(1)
    grads = [jax.tree_util.tree_map(lambda x: rng.standard_normal(x.shape).astype(np.float32),
                                    params) for _ in range(steps + 3)]
    for g in grads[:steps]:
        upd, state = tx.update(g, state, params)
        params = optax.apply_updates(params, upd)
    loaded = C.msgpack_restore(fs.to_bytes(state))
    with torch.no_grad():
        for (name, p), v in zip(named.items(), (params["a"]["kernel"], params["a"]["bias"],
                                                params["frozen"])):
            p.copy_(torch.from_numpy(np.array(v)))
    port.load_state_dict(C.optax_state_dict(loaded, port, named))
    for g in grads[steps:]:
        upd, state = tx.update(g, state, params)
        params = optax.apply_updates(params, upd)
        for (name, p), v in zip(named.items(), (g["a"]["kernel"], g["a"]["bias"], g["frozen"])):
            p.grad = torch.from_numpy(np.asarray(v))
        port.step()
        port.zero_grad()
    np.testing.assert_allclose(named["a.kernel"].detach().numpy(), params["a"]["kernel"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(named["a.bias"].detach().numpy(), params["a"]["bias"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(named["frozen"].detach().numpy(), params["frozen"])


@pytest.mark.parametrize("what", ["accumulates", "unclipped", "unnamed"])
def test_optax_layout_mismatch_raises(what):
    params, tx, named, port = _optax_pair(2, True)
    state = C.msgpack_restore(fs.to_bytes(tx.init(params)))
    if what == "accumulates":
        _, _, named, port = _optax_pair(1, True)
        match = "MultiSteps"
    elif what == "unclipped":
        _, _, named, port = _optax_pair(2, False)
        match = "inner_states"
    else:
        named = {"x." + k: v for k, v in named.items()}
        match = "a.kernel|x.a.kernel"
    with pytest.raises(ValueError, match=match):
        C.optax_state_dict(state, port, named)


# ---------------------------------------------------------------------------
# real JAX checkpoints
# ---------------------------------------------------------------------------
def _records(run_root: Path, kind: str):
    return [r for p in run_root.rglob("records.jsonl")
            for r in map(json.loads, p.read_text().splitlines()) if r.get("type") == kind]


@pytest.fixture(scope="module")
def adapter_run(tmp_path_factory):
    """The port's store at test size, a JAX ``train_adapter`` run over it and
    the JAX ``eval_adapter``'s record of its last checkpoint."""
    from summer_clip_tpu.apps import eval_adapter as jea
    from summer_clip_tpu.apps import train_adapter as jta

    from summer_clip_torch.apps import save_features

    tmp = tmp_path_factory.mktemp("jax_adapter")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        save_features.run(argv=[
            "meta.device=cpu", "dataset_name=synthetic", "dataset@train_dataset=synthetic_train",
            "dataset@test_dataset=synthetic_test", "clip=test_vit", "data.batch_size=8",
            f"store.root={tmp / 'features'}"])
        common = ["clip=test_vit", "dataset_name=synthetic", f"store.root={tmp / 'features'}"]
        jta.run(argv=common + [
            "dataset=synthetic_train", "dataset.load_images=false", "adapter=original_image",
            "data.features_key=synthetic_train-test-vit", "data.batch_size=8",
            "training.epochs_num=2", "training.adam_params.lr=0.01",
            f"data.checkpoints_dir={tmp / 'checkpoints'}"])
        ckpt_dir = tmp / "checkpoints" / "epoch_2"
        evaluate = common + ["dataset=synthetic_test", "dataset.load_images=false",
                             f"eval.checkpoint_dir={ckpt_dir}",
                             "eval.features_key=synthetic_test-test-vit"]
        jea.run(argv=evaluate)
    finally:
        os.chdir(cwd)
    want, = _records(tmp, "eval_adapter")
    return {"root": tmp, "ckpt": ckpt_dir, "argv": evaluate, "want": want}


def test_eval_adapter_reads_a_jax_train_adapter_run(adapter_run, tmp_path, monkeypatch):
    """The port's ``eval_adapter`` on the JAX checkpoint, with the JAX
    session's CLIP weights: the JAX app's accuracy; the adapter's features
    against the JAX adapter's within 1e-4."""
    from summer_clip_tpu.apps.common import create_clip_session as jax_session
    from summer_clip_tpu.methods import adapters as JA

    from summer_clip_torch.apps import eval_adapter as pea
    from summer_clip_torch.core import config as PC
    from summer_clip_torch.methods.adapters import state_dict_from_tree
    from summer_clip_torch.models.clip import from_flax_variables

    loaded = C.load_checkpoint(adapter_run["ckpt"])
    clip = loaded["meta"]["clip"]
    variables = jax.tree_util.tree_map(np.asarray, jax_session(
        clip["model_name"], clip.get("checkpoint_path"), clip.get("dtype")).variables)
    real = pea.create_clip_session

    def session(*a, **k):
        s = real(*a, **k)
        s.model.load_state_dict(from_flax_variables(variables))
        return s

    monkeypatch.setattr(pea, "create_clip_session", session)
    monkeypatch.chdir(tmp_path)
    pea.run(argv=adapter_run["argv"] + ["meta.device=cpu"])
    got, = _records(tmp_path, "eval_adapter")
    want = adapter_run["want"]
    assert (got["acc1"], got["acc5"]) == (want["acc1"], want["acc5"])

    assert loaded["meta"]["adapter"]["_target_"].startswith("summer_clip_torch.")
    fabric = PC.instantiate(loaded["meta"]["adapter"])
    adapter = fabric.create_adapter(int(loaded["meta"]["emb_dim"]))
    adapter.load_state_dict(state_dict_from_tree(loaded["params"]))
    feats = np.random.default_rng(0).standard_normal((6, int(loaded["meta"]["emb_dim"])))
    feats = feats.astype(np.float32)
    jparams = fs.msgpack_restore((adapter_run["ckpt"] / "model.ckpt").read_bytes())
    jad = JA.OriginalImageClipAdapterFabric(**{k: v for k, v in loaded["meta"]["adapter"].items()
                                               if k != "_target_"}).create_adapter(feats.shape[1])
    want_f = jad.apply({"params": jparams}, jnp.asarray(feats), method=lambda m, f: m.image_adapter(f))
    with torch.no_grad():
        got_f = adapter.encode(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got_f, np.asarray(want_f), rtol=1e-4, atol=1e-4)


GPT_COMMON = ["clip_gpt.gpt_config=test-gpt", "clip_gpt.clip_emb_dim=16",
              "clip_gpt.adapters.emb_hid_dim=16", "clip_gpt.adapters.head_hid_dim=16",
              "data_loader.train.batch_size=4", "data_loader.val.batch_size=4",
              "training.epochs_num=1", "training.grad_accum_steps=2",
              "training.clip_grad_norm=0.5", "training.bf16=false", "training.remat=false",
              "optim.adamw_kwargs.lr=0.01", "scheduler.warmup_part=0.2"]


def _gpt_cfg(package: str, overrides):
    if package == "summer_clip_tpu":
        from summer_clip_tpu.core import config as cfg_mod
    else:
        from summer_clip_torch.core import config as cfg_mod
    cfg = cfg_mod.compose(ROOT / package / "conf", "train_gpt", GPT_COMMON + list(overrides))
    cfg.pop("hydra")
    return cfg


@pytest.fixture(scope="module")
def gpt_run(tmp_path_factory):
    """A JAX ``train_gpt`` trainer at test-gpt: 4 micro-steps (2 updates), a
    step checkpoint with its optimizer and the whole tree as a base file,
    then 4 micro-steps more: their losses, the final tree and optax state."""
    from summer_clip_tpu.apps.train_gpt import ClipGPTTrainer as JT
    from summer_clip_tpu.engine.checkpoint import save_pytree

    root = tmp_path_factory.mktemp("jax_gpt")
    tokens = np.random.default_rng(0).integers(0, 49408, (40, 16)).astype(np.int32)
    np.save(root / "tokens.npy", tokens)
    data = [f"dataset.train.tokens_path={root / 'tokens.npy'}",
            f"training.checkpoints_dir={root / 'ckpts'}"]
    cwd = os.getcwd()
    os.chdir(root)
    try:
        jt = JT(_gpt_cfg("summer_clip_tpu", data))
        jt.setup()
        batches = [tokens[4 * k: 4 * k + 4] for k in range(8)]
        for ids in batches[:4]:
            jt.params, jt.opt_state, _ = jt._train_step(jt.params, jt.opt_state, jnp.asarray(ids))
        jt.save_step_model(1, 4, with_optimizer=True)
        save_pytree(root / "base.msgpack", jt.params)
        losses = []
        for ids in batches[4:]:
            jt.params, jt.opt_state, loss = jt._train_step(jt.params, jt.opt_state,
                                                           jnp.asarray(ids))
            losses.append(float(loss))
    finally:
        os.chdir(cwd)
    return {"root": root, "data": data, "batches": batches, "losses": losses, "trainer": jt,
            "step": root / "ckpts" / "epoch_1" / "step_4", "base": root / "base.msgpack",
            "final": jax.tree_util.tree_map(np.asarray, jt.params),
            "opt": fs.to_state_dict(jt.opt_state)}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (str(k),))
        else:
            yield ".".join(prefix + (str(k),)), np.asarray(v)


def test_train_gpt_resumes_a_jax_run_with_its_optimizer(gpt_run, tmp_path, monkeypatch):
    from summer_clip_torch.apps.train_gpt import ClipGPTTrainer as PT

    monkeypatch.chdir(tmp_path)
    pt = PT(_gpt_cfg("summer_clip_torch", gpt_run["data"] + [
        "meta.device=cpu", f"pretrained.model={gpt_run['step']}", "pretrained.optimizer=true",
        f"+pretrained.base={gpt_run['base']}"]))
    pt.setup()
    assert (pt.tx.calls, pt.tx.count) == (4, 2)
    losses = [pt.train_step(torch.from_numpy(ids.astype(np.int64)))
              for ids in gpt_run["batches"][4:]]
    np.testing.assert_allclose(losses, gpt_run["losses"], rtol=2e-6)
    final = dict(_flat(gpt_run["final"]))
    named = dict(pt.model.named_parameters())
    assert set(named) == set(final)
    for name, p in named.items():
        if name.startswith("adapter_"):
            np.testing.assert_allclose(p.detach().numpy(), final[name], rtol=0, atol=2e-5,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(p.detach().numpy(), final[name], err_msg=name)
    labels = gpt_run["opt"]["inner_opt_state"]["1"]["inner_states"]
    moments = {}
    for label in ("decay", "no_decay"):
        adam = labels[label]["inner_state"]["0"]
        moments.update({n: (m, v) for (n, m), (_, v) in zip(_flat(adam["mu"]), _flat(adam["nu"]))})
    state = pt.tx.inner.optimizer.state
    assert {n for n, p in named.items() if p in state} == set(moments) and len(moments) == 4
    for name, (mu, nu) in moments.items():
        np.testing.assert_allclose(state[named[name]]["exp_avg"].numpy(), mu, rtol=0, atol=2e-5)
        np.testing.assert_allclose(state[named[name]]["exp_avg_sq"].numpy(), nu, rtol=0,
                                   atol=2e-5)
        assert int(state[named[name]]["step"]) == 4


def test_jax_step_checkpoint_needs_base_and_gives_jax_logits(gpt_run):
    from summer_clip_tpu.apps.gen_gpt import load_pretrained_clip_gpt as jax_load
    from summer_clip_tpu.models.tokenizer import get_tokenizer as jax_tokenizer

    from summer_clip_torch.apps.gen_gpt import load_pretrained_clip_gpt
    from summer_clip_torch.models.tokenizer import get_tokenizer

    with pytest.raises(ValueError, match=r"init_key.*base=|frozen ones \(clip_emb"):
        load_pretrained_clip_gpt(gpt_run["step"], get_tokenizer(), device="cpu")
    model = load_pretrained_clip_gpt(gpt_run["step"], get_tokenizer(), device="cpu",
                                     base=gpt_run["base"])
    jm, variables = jax_load(gpt_run["step"], jax_tokenizer())
    ids = gpt_run["batches"][0][:2]
    want = np.asarray(jm.apply(variables, jnp.asarray(ids))["logits"])
    with torch.no_grad():
        got = model(torch.from_numpy(ids.astype(np.int64)))["logits"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_gen_gpt_app_samples_a_jax_step_checkpoint_with_base(gpt_run, tmp_path, monkeypatch):
    """The port's ``gen_gpt`` app on the JAX step checkpoint (``+model.base``)
    greedy-samples the JAX app's text; without ``base`` it raises."""
    from summer_clip_tpu.apps import gen_gpt as jgen

    from summer_clip_torch.apps import gen_gpt as pgen

    argv = [f"model.checkpoint_dir={gpt_run['step']}", "generation.max_new_tokens=4",
            "generation.top_k=1", 'prompts=["a photo of","the"]']
    texts = {}
    for name, run, extra in (("jax", jgen.run, []),
                             ("port", pgen.run, ["meta.device=cpu",
                                                 f"+model.base={gpt_run['base']}"])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        run(argv=argv + extra)
        texts[name] = [r["text"] for r in _records(tmp_path / name, "generation")]
    assert len(texts["port"]) == 2 and texts["port"] == texts["jax"]
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="base="):
        pgen.run(argv=argv + ["meta.device=cpu"])
