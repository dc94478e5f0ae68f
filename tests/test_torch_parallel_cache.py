"""The serving side of the port's multi-device layer, cache and extraction, against
the JAX package on the CPU.

One gloo group of 4 ranks is started once for the file (``parallel.launch``,
``tests/torch_parallel_ranks.cache_rank``); it builds meshes, runs the
sharded and resident caches, data-parallel extraction through the library and
through ``save_features``, and ``image_attention`` over a written store. This
process holds what the ranks return against the JAX package's functions on its
virtual mesh (``tests/conftest.py``) and against the port's one-device runs,
with the JAX package's own tolerances (``tests/test_parallel.py``: 1e-4 for the
sharded cache against dense and for DP extraction). Cases that need no process
group simulate the ranks in this process and sum their partials.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from summer_clip_torch.parallel import (Mesh, ShardedResidentCache, launch, pad_cache_for_mesh,
                                        sharded_cache_logits)
from tests import torch_parallel_ranks as R

WORLD = 4
TOPK_GROUPS = ("topk", "topk_prob", "topk_per_gold", "topk_prob_per_gold",
               "per_pred_class_random", "per_gold_class_random", "global_random")


def _unit(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _cache_case(seed, nt, nc, d, c, n_sel):
    rng = np.random.RandomState(seed)
    cache = rng.randn(nc, d).astype(np.float32)
    outs = rng.randn(nc, c).astype(np.float32)
    sel = np.sort(rng.choice(nc, n_sel, replace=False))
    return {"f": _unit(rng.randn(nt, d).astype(np.float32)), "cache": cache, "outs": outs,
            "betas": [0.5, 5.5], "scale": 5.0,
            "selections": {"all": np.arange(nc), "subset": sel}}


def _write_store(root: Path) -> None:
    """A feature store for ``image_attention``: the synthetic split sizes, the
    test-vit embedding width."""
    from summer_clip_torch.store import FeatureStore

    rng = np.random.RandomState(7)
    fs = FeatureStore(root / "ia_store")
    fs.save("synthetic_test-test-vit", features=rng.randn(16, 32).astype(np.float32))
    fs.save("synthetic_train-test-vit", features=rng.randn(32, 32).astype(np.float32))
    fs.save("synthetic_train_outs-test-vit", outs=rng.randn(32, 4).astype(np.float32))


def _ia_argv(root: Path, ckpt: str) -> list:
    return ["clip=test_vit", f"clip.checkpoint_path={ckpt}", "dataset_name=synthetic",
            f"store.root={root / 'ia_store'}", "dataset=synthetic_test",
            "dataset@cache.dataset=synthetic_train", "dataset.load_images=false",
            "cache.dataset.load_images=false", "data.features_key=synthetic_test-test-vit",
            "cache.features_key=synthetic_train-test-vit",
            "cache.outs_key=synthetic_train_outs-test-vit", "cache_value_strategy=softmax_cache",
            "cache_value_strategy.scale=[1.0]", "cache.alpha=[0.0,1.0]",
            "cache_weights_strategy.beta=[1.0,5.5]",
            *[f"cache_strategies.{g}.topk=[4]" for g in TOPK_GROUPS]]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from summer_clip_torch.models.clip import build_clip, to_openai_state_dict

    model, _ = build_clip("test-vit", torch.Generator().manual_seed(5), device="cpu")
    path = tmp_path_factory.mktemp("ckpt") / "test_vit.pt"
    torch.save(to_openai_state_dict(model), path)
    return str(path)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, ckpt):
    root = tmp_path_factory.mktemp("ranks")
    sf = ["clip=test_vit", f"clip.checkpoint_path={ckpt}", "meta.device=cpu",
          "dataset_name=synthetic", "dataset@train_dataset=synthetic_train",
          "dataset@test_dataset=synthetic_test", "data.batch_size=8", "save_train_outs=false"]
    rng = np.random.RandomState(0)
    nt, nc, d, c = 12, 37, 16, 5            # nc not divisible by the ranks
    case = {"f": _unit(rng.randn(nt, d).astype(np.float32)),
            "cache": _unit(rng.randn(nc, d).astype(np.float32)),
            "values": rng.randn(nc, c).astype(np.float32), "betas": [0.5, 5.5, 11.0],
            # the small cache; and one of 1200 rows over 300 classes, where a
            # rank's block spans more than 128 classes (the K2 route)
            "resident": {"small": _cache_case(2, 9, 37, 16, 5, 6),
                         "many": _cache_case(3, 8, 1200, 16, 300, 500)},
            "save_features": sf,
            "image_attention": _ia_argv(root, ckpt) + ["meta.device=cpu"],
            "tip_adapter": sf[:3] + ["dataset=synthetic", "root_path=''", "shots=2",
                                     "augment_epoch=2", "data.batch_size=8", "search_step=[4,3]",
                                     "search_scale=[7,3]"],
            "train_prolip": sf[:3] + ["dataset=synthetic", "root_path=''", "shots=8",
                                      "data.batch_size=8", "train.epochs=5"]}
    _write_store(root)
    results = launch(R.cache_rank, ["cpu"] * WORLD, str(root), case)
    one = launch(R.save_features_rank, ["cpu"], str(root), sf, case)
    return {"root": root, "case": case, "values": [r.value for r in results],
            "launches": [r.launches for r in results] + [one[0].launches]}


def _jax_mesh(devices8, data, model):
    from summer_clip_tpu.parallel import create_mesh

    return create_mesh(data=data, model=model, devices=devices8[:data * model])


def test_create_mesh_lays_ranks_out_row_major(ranks):
    shapes = [{"data": 2, "model": 2}, {"data": 4, "model": 1}, {"data": 1, "model": 4}]
    for r, v in enumerate(ranks["values"]):
        for (shape, coords, grouped), want in zip(v["meshes"], shapes):
            assert shape == want
            assert coords == {"data": r // want["model"], "model": r % want["model"]}
            assert grouped == ["data", "model"]        # every axis has its group in a process group
        np.testing.assert_array_equal(v["shard"], np.arange(32, dtype=np.float32).reshape(8, 4)[
            2 * r:2 * r + 2])
        np.testing.assert_array_equal(v["replicate"], np.ones(3))
    # no process group: one rank, nothing to reduce
    from summer_clip_torch.parallel import create_mesh

    mesh = create_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.groups == {"data": None, "model": None}
    with pytest.raises(ValueError):
        create_mesh(data=2)


def test_distributed_init_joins_the_group_the_environment_names(monkeypatch):
    """No torchrun variables: nothing happens. With them (one rank, a free
    port on localhost) the process joins a gloo group on the CPU, and a second
    call keeps it."""
    import socket

    import torch.distributed as dist

    from summer_clip_torch.parallel import create_mesh, distributed_init

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert not distributed_init() and not dist.is_initialized()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "localhost",
                 "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(k, v)
    try:
        assert distributed_init() and dist.get_backend() == "gloo"
        assert distributed_init() and dist.get_world_size() == 1
        mesh = create_mesh()
        assert mesh.groups["data"] is dist.group.WORLD and mesh.leads
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("batcher", ["image", "synthetic"])
def test_batcher_shards_split_every_batch_evenly(batcher):
    """``shard(i, n)``: rank i of n gets rows [i b/n, (i+1) b/n) of every padded
    batch and renders only those; the shards' real rows are the batcher's, each
    once, and a shard of a tail batch that holds padding only is all masked."""
    from summer_clip_torch.data.datasets import SyntheticBatcher, SyntheticDataset
    from summer_clip_torch.data.loader import ImageBatcher
    from summer_clip_torch.data.transforms import EvalTransform

    items = SyntheticDataset(num_classes=2, per_class=10, image_size=8).train_x   # 20 rows
    whole = (ImageBatcher(items, 8, EvalTransform(8), num_threads=2) if batcher == "image"
             else SyntheticBatcher(items, 8, 8))
    full = list(whole)
    rows = {i: list(whole.shard(i, 4)) for i in range(4)}
    assert whole.rows == slice(0, 8)   # sharding leaves the batcher whole
    for b, batch in enumerate(full):
        for i in range(4):
            part = rows[i][b]
            assert part.images.shape == (2,) + batch.images.shape[1:]
            for field in ("images", "labels", "indices", "mask"):
                np.testing.assert_array_equal(getattr(part, field),
                                              getattr(batch, field)[2 * i:2 * i + 2])
    assert not rows[2][2].mask.any() and not rows[3][2].mask.any()   # the tail: rows 16..19
    with pytest.raises(ValueError):
        whole.shard(0, 3)


@pytest.mark.parametrize("mesh_name,shape", [("model4", (1, 4)), ("data2_model2", (2, 2))])
def test_sharded_cache_logits_match_jax(ranks, devices8, mesh_name, shape):
    import jax.numpy as jnp

    from summer_clip_tpu.ops.cache_kernels import cache_attention_reference
    from summer_clip_tpu.parallel import sharded_cache_logits as jax_sharded

    c = ranks["case"]
    want = np.asarray(jax_sharded(c["f"], c["cache"], c["values"], jnp.asarray(c["betas"]),
                                  _jax_mesh(devices8, *shape), axis="model"))
    dense = np.asarray(cache_attention_reference(jnp.asarray(c["f"]), jnp.asarray(c["cache"]),
                                                 jnp.asarray(c["values"]),
                                                 jnp.asarray(c["betas"])))
    for v in ranks["values"]:
        got = v["sharded", mesh_name]
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got, dense, atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(got, ranks["values"][0]["sharded", mesh_name])


def _dense_oracle(c, inds, kind):
    from summer_clip_torch.ops.cache_kernels import cache_attention_reference

    outs = torch.from_numpy(c["outs"][inds])
    vals = (torch.nn.functional.one_hot(outs.argmax(1), outs.shape[1]).float() if kind == "hard"
            else torch.softmax(c["scale"] * outs, dim=1))
    return cache_attention_reference(torch.from_numpy(c["f"]),
                                     torch.from_numpy(_unit(c["cache"][inds])), vals,
                                     torch.tensor(c["betas"])).numpy()


@pytest.mark.parametrize("cname", ["small", "many"])
def test_resident_cache_matches_jax(ranks, devices8, cname):
    """Hard and Softmax values, the identity and a strict subset, against the
    JAX ``ShardedResidentCache`` on a 4-way mesh (the small cache) or the dense
    oracle on the selected rows (the JAX tests' reference; the cache of 300
    classes), within 1e-4; every rank the same."""
    import jax.numpy as jnp

    from summer_clip_tpu.parallel import ShardedResidentCache as JaxResident

    c = ranks["case"]["resident"][cname]
    jres = (JaxResident(c["cache"], c["outs"], _jax_mesh(devices8, 1, 4), axis="model")
            if cname == "small" else None)
    for r, v in enumerate(ranks["values"]):
        assert v["padded_rows", cname] % (WORLD * 1024) == 0
        for sel, inds in c["selections"].items():
            for kind in ("hard", "softmax"):
                got = v["resident", cname, sel, kind]
                want = (np.asarray(jres.logits(jnp.asarray(c["f"]), inds, c["betas"], kind=kind,
                                               scale=c["scale"])) if jres is not None
                        else _dense_oracle(c, inds, kind))
                np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4,
                                           err_msg=f"{cname} {sel} {kind} rank {r}")
                np.testing.assert_array_equal(got, ranks["values"][0]["resident", cname, sel, kind])


def _fake_mesh(rank: int, model: int) -> Mesh:
    """Rank ``rank`` of a 1 x ``model`` mesh without a process group: its
    collectives do nothing, so its results are its partials."""
    return Mesh({"data": 1, "model": model}, {"data": 0, "model": rank}, rank,
                torch.device("cpu"), {"data": None, "model": None})


@pytest.mark.parametrize("kind", ["hard", "softmax"])
def test_simulated_ranks_partials_sum_to_the_dense_oracle(kind):
    """The per-rank math in one process: three simulated ranks each hold their
    block of the padded, prediction-sorted cache, and their partials summed
    are the dense oracle on the selected rows (zero and -1 rows add nothing)."""
    c = _cache_case(4, 7, 2100, 16, 6, 50)
    parts = []
    for r in range(3):
        res = ShardedResidentCache(c["cache"], c["outs"], _fake_mesh(r, 3))
        assert res.rows_per_rank == 1024 and res.padded_rows == 3072
        parts.append(res.logits(c["f"], c["selections"]["subset"], c["betas"], kind=kind,
                                scale=c["scale"]))
    want = _dense_oracle(c, c["selections"]["subset"], kind)
    np.testing.assert_allclose(sum(parts).numpy(), want, atol=1e-5, rtol=1e-5)


def test_pad_and_host_values_shards():
    rng = np.random.RandomState(1)
    f, v = rng.randn(37, 8).astype(np.float32), rng.randint(0, 2, (37, 3)).astype(np.int64)
    fp, vp = pad_cache_for_mesh(f, v, 2)
    assert fp.shape == (2048, 8) and vp.shape == (2048, 3) and not vp[37:].any()
    test = _unit(rng.randn(5, 8).astype(np.float32))
    parts = sum(sharded_cache_logits(test, f, v, [1.0, 3.0], _fake_mesh(r, 2)) for r in range(2))
    from summer_clip_torch.ops.cache_kernels import cache_attention_reference

    want = cache_attention_reference(torch.from_numpy(test), torch.from_numpy(f),
                                     torch.from_numpy(v).float(), torch.tensor([1.0, 3.0]))
    torch.testing.assert_close(parts, want, atol=1e-5, rtol=1e-5)


def test_dp_extraction_matches_one_device(ranks):
    """The library: each of 4 ranks renders and encodes only its 2 rows of a
    batch of 8 (a padded tail batch too: ranks 2 and 3 hold padding only);
    rank 0 holds every row's features, in the one-device run's order, within
    1e-4 (tests/test_parallel.py's tolerance), and the other ranks none."""
    values = ranks["values"]
    (fm, lm, im), (f1, l1, i1) = values[0]["dp"], values[0]["one"]
    assert fm.shape == (12, 32)
    np.testing.assert_array_equal(lm, l1)
    np.testing.assert_array_equal(im, i1)
    np.testing.assert_allclose(fm, f1, atol=1e-4, rtol=1e-4)
    for v in values[1:]:
        assert [a.shape for a in v["dp"]] == [(0, 32), (0,), (0,)]
        np.testing.assert_array_equal(v["one"][0], f1)
    assert [v["rendered"] for v in values] == [[0, 1, 8, 9], [2, 3, 10, 11], [4, 5], [6, 7]]


def test_save_features_store_at_world_4_is_the_world_1_store(ranks):
    """``save_features`` inside the 4-rank group (batch 8 divides: data
    parallel) against the same app in a group of one: the same catalog keys,
    labels and row order, features within 1e-4; only rank 0 wrote."""
    from summer_clip_torch.store import FeatureStore

    root = ranks["root"]
    w4, w1 = FeatureStore(root / "store_w4"), FeatureStore(root / "store_w1")
    for key in ("synthetic_train-test-vit", "synthetic_test-test-vit"):
        assert key in w4 and key in w1
        np.testing.assert_array_equal(w4.load(key, "labels"), w1.load(key, "labels"))
        np.testing.assert_allclose(w4.load(key, "features"), w1.load(key, "features"),
                                   atol=1e-4, rtol=1e-4)
    logs = sorted((root / "save_features_w4").rglob("records.jsonl"))
    assert [p.relative_to(root / "save_features_w4").parts[0] for p in logs] == ["rank0"]


@pytest.mark.parametrize("app,kind", [("tip_adapter", "tip_searched"),
                                      ("train_prolip", "prolip_result")])
def test_few_shot_apps_at_world_4_give_the_world_1_records(ranks, app, kind):
    """``tip_adapter`` and ``train_prolip`` in the 4-rank group (batch 8: each
    rank extracts 2 rows of every batch, rank 0 gathers them and goes on)
    against the same app in a group of one: the same result records within
    1e-4 (the DP tolerance), written by rank 0 alone; the other ranks leave
    after their extractions without a record or a cache of their own."""
    root = ranks["root"]
    runs = sorted((root / f"{app}_w4").rglob("records.jsonl"))
    assert [p.relative_to(root / f"{app}_w4").parts[0] for p in runs] == ["rank0"]
    assert not [f for f in (root / f"{app}_w4").glob("rank[123]/**/caches/**/*") if f.is_file()]
    got, want = _records(root / f"{app}_w4", kind), _records(root / f"{app}_w1", kind)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            assert g[k] == (pytest.approx(v, abs=1e-4) if isinstance(v, float) else v), k


def _records(run_root: Path, kind: str):
    recs = []
    for p in sorted(run_root.rglob("records.jsonl")):
        text = p.read_text().replace("summer_clip_tpu.", "summer_clip_torch.")
        recs.extend(json.loads(line) for line in text.splitlines())
    return [r for r in recs if r.get("type") == kind]


def _by_combo(recs):
    def key(r):
        return json.dumps({k: r[k] for k in ("cache_strategy", "cache_weights_strategy",
                                             "cache_value_strategy", "alpha")}, sort_keys=True)
    out = {key(r): r for r in recs}
    assert len(out) == len(recs)
    return out


def test_image_attention_at_world_4_matches_the_jax_app(ranks, ckpt, tmp_path, monkeypatch):
    """The port's image_attention with the cache split over 4 ranks (resident
    shards, K1's plain version a rank) against the JAX app on its 8-device
    mesh over the same store: every record, accuracies within 1e-4; rank 0
    alone wrote records."""
    from summer_clip_tpu.apps import image_attention as jia

    root = ranks["root"]
    monkeypatch.chdir(tmp_path)
    jia.run(argv=_ia_argv(root, ckpt))
    runs = sorted((root / "image_attention").rglob("records.jsonl"))
    assert [p.relative_to(root / "image_attention").parts[0] for p in runs] == ["rank0"]
    got = _by_combo(_records(root / "image_attention", "searcher_result"))
    want = _by_combo(_records(tmp_path, "searcher_result"))
    assert len(want) == (7 + 1) * 2 * 2
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k]["acc1"] == pytest.approx(w["acc1"], abs=1e-4), k
        assert got[k]["acc5"] == pytest.approx(w["acc5"], abs=1e-4), k
    zero_t = _records(root / "image_attention", "zero_shot")
    zero_j = _records(tmp_path, "zero_shot")
    assert len(zero_t) == len(zero_j) == 1
    assert zero_t[0]["acc1"] == pytest.approx(zero_j[0]["acc1"], abs=1e-4)
