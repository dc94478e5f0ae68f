"""ProLIP of the port against the JAX package: ``methods/prolip``
(``prolip_logits``, ``train_projection``'s W and loss curve), the
``ClipSession`` members it needs, and the ``train_prolip`` app's records, at
the JAX e2e test's size (``test_vit`` on ``synthetic``, 8 shots, 60 epochs).

Both packages read one OpenAI-layout ``.pt`` of the same random weights and
run in this one process (the synthetic images seed from the salted
``hash(impath)``, so they agree only within a process). Tolerances: logits
1e-5; W and the logged losses 1e-4 relative (full-batch Adam in f32, sums in
another order); accuracies exact (the same argmax on every row); the
pre-projection features 1e-4.

The ``cuda`` test runs phase (j) of ``chip_smoke.py`` at test size on the card.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from summer_clip_torch.methods import prolip


def _problem(seed=0, n=24, width=16, dim=8, c=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, width)).astype(np.float32)
    labels = np.arange(n) % c
    t = rng.standard_normal((c, dim)).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    w0 = (rng.standard_normal((width, dim)) / np.sqrt(width)).astype(np.float32)
    return x, labels, t, w0


def test_prolip_logits_and_train_projection_match_jax():
    """The logits, then 40 full-batch steps: W and every logged loss and CE
    record (the JAX steps: 0, 10, 20, 30 and the last)."""
    import jax.numpy as jnp

    from summer_clip_tpu.methods import prolip as jprolip

    x, labels, t, w0 = _problem()
    np.testing.assert_allclose(prolip.prolip_logits(x, torch.from_numpy(w0), t, 50.0,
                                                     device="cpu").numpy(),
                               np.asarray(jprolip.prolip_logits(jnp.asarray(x), jnp.asarray(w0),
                                                                jnp.asarray(t), 50.0)),
                               rtol=1e-5, atol=1e-5)
    kw = dict(epochs=40, lr=0.01, weight_decay_to_init=0.5, scale=50.0, log_every=10)
    jrecs, recs = [], []
    want = jprolip.train_projection(x, labels, t, w0, log_fn=jrecs.append, **kw)
    got = prolip.train_projection(x, labels, t, w0, log_fn=recs.append, device="cpu", **kw)
    assert np.abs(got - w0).max() > 1e-3                       # W moved
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    assert [r["epoch"] for r in recs] == [r["epoch"] for r in jrecs] == [0, 10, 20, 30, 39]
    for key in ("loss", "ce"):
        np.testing.assert_allclose([r[key] for r in recs], [r[key] for r in jrecs], rtol=1e-4)
    assert recs[-1]["ce"] < recs[0]["ce"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``train_prolip`` of each package over one checkpoint, each in its own
    directory, and the port's trainer."""
    import os

    from summer_clip_tpu.apps import train_prolip as japp

    from summer_clip_torch.apps import train_prolip as papp
    from summer_clip_torch.models.clip import build_clip, to_openai_state_dict

    tmp = tmp_path_factory.mktemp("prolip")
    model, _ = build_clip("test-vit", torch.Generator().manual_seed(19), device="cpu")
    ckpt = tmp / "test_vit.pt"
    torch.save(to_openai_state_dict(model), ckpt)
    argv = ["dataset=synthetic", "clip=test_vit", f"clip.checkpoint_path={ckpt}", "root_path=''",
            "shots=8", "data.batch_size=8", "train.epochs=60", "train.lr=0.003"]
    captured = {}
    real = papp.run_trainer
    papp.run_trainer = lambda cls, cfg: captured.setdefault("trainer", real(cls, cfg))
    cwd = os.getcwd()
    try:
        for name, app, extra in (("jax", japp, []), ("port", papp, ["meta.device=cpu"])):
            (tmp / name).mkdir()
            os.chdir(tmp / name)
            app.run(argv=argv + extra)
    finally:
        os.chdir(cwd)
        papp.run_trainer = real
    return tmp, captured["trainer"]


def _records(run_root: Path):
    out = []
    for p in sorted(run_root.rglob("records.jsonl")):
        out.extend(json.loads(line) for line in p.read_text().splitlines())
    return [r for r in out if r.get("type") in ("zero_shot", "prolip_train", "prolip_result",
                                                 "prolip_proj_saved")]


def test_train_prolip_records_match_jax(runs):
    """Every record of the two runs: the same types in the same order,
    accuracies equal, losses to 1e-4; the stored projection and the .npy."""
    tmp, _ = runs
    want, got = _records(tmp / "jax"), _records(tmp / "port")
    assert [r["type"] for r in got] == [r["type"] for r in want]
    assert [r["type"] for r in got].count("prolip_train") == 4
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            if isinstance(v, float) and k in ("loss", "ce"):
                assert g[k] == pytest.approx(v, rel=1e-4), (w["type"], k)
            else:
                assert g[k] == v, (w["type"], k)
    res = [r for r in got if r["type"] == "prolip_result"][-1]
    assert res["acc1_train"] > res["acc1_train_zero_shot"]
    for name in ("jax", "port"):
        assert list((tmp / name).rglob("caches/*/prolip_proj_8shots*"))
    w_port = np.load(next((tmp / "port").rglob("prolip_proj.npy")))
    w_jax = np.load(next((tmp / "jax").rglob("prolip_proj.npy")))
    np.testing.assert_allclose(w_port, w_jax, rtol=1e-4, atol=1e-4 * np.abs(w_jax).max())


def test_clip_session_preprojection_members_match_jax(runs):
    """``encode_image_preproj``, ``vision_projection`` and ``embed_dim`` of
    the port's session against the JAX session on the same weights and
    images; the pre-projection features times W0 are the image features."""
    import jax.numpy as jnp

    from summer_clip_tpu.apps.common import create_clip_session as jcreate

    tmp, trainer = runs
    session = trainer.session
    jsession = jcreate("test-vit", str(next(tmp.glob("*.pt"))))
    images = np.random.default_rng(20).standard_normal((3, 32, 32, 3)).astype(np.float32)
    got = session.encode_image_preproj(images).numpy()
    want = np.asarray(jsession.encode_image_preproj(jnp.asarray(images)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(session.vision_projection(), jsession.vision_projection(),
                               rtol=1e-6, atol=1e-7)
    assert session.embed_dim == jsession.embed_dim == 32
    np.testing.assert_allclose(got @ session.vision_projection(),
                               session.encode_image(images).numpy(), rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------- #
# on the card: chip_smoke's (j) at test size
# --------------------------------------------------------------------------- #
@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_prolip_gates_at_test_size(cuda, tmp_path):
    """(j) train_prolip over a 2-block ViT-B/16-width image tower on the
    card: W against ``train_projection`` on the CPU, CE falls, exact K5 and
    K6 launch counts."""
    import chip_smoke

    chip_smoke.run_small_prompt_search(tmp_path, "j")
