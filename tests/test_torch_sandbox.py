"""``summer_clip_torch.sandbox`` against ``summer_clip_tpu.sandbox`` at ``test-gpt``.

The cases of ``tests/test_sandbox.py`` as parity tests. The JAX GPT-2 is
initialised from a key and crosses to the port through
``models.gpt2.from_flax_variables``; where the JAX package draws
``jax.random.permutation(PRNGKey(seed), V)`` (k-means' first centroids, the
random init) that permutation is carried across (``permutation=``); the numpy
draws (batches, HotFlip slots, re-initialisation) are equal by seed. Both
CLIs of each module read a tree that the JAX package's ``save_pytree`` wrote.

Tolerances, f32 on the CPU in both packages: logits 1e-4 (sums in another
order, as ``tests/test_torch_gpt2.py``), the optimised inputs 1e-4 after a few
Adam or SGD steps, losses and metrics 1e-4 relative; ids, slots, acceptances
and found records equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from summer_clip_torch.models import gpt2 as tg
from summer_clip_torch.sandbox import anomalous_tokens as PA
from summer_clip_torch.sandbox import create_trigger as PC
from summer_clip_torch.sandbox import mlm_trigger as PM

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def gpt():
    """(JAX model, JAX params, port model) on the same numbers."""
    from summer_clip_tpu.models import gpt2 as jg

    model, _ = jg.build_gpt2("test-gpt")
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    port = tg.GPT2(tg.GPT2_CONFIGS["test-gpt"])
    port.load_tree(tg.from_flax_variables(jax.tree_util.tree_map(np.asarray, params)))
    return model, params, port.eval()


@pytest.fixture(scope="module")
def tree_file(gpt, tmp_path_factory):
    from summer_clip_tpu.engine.checkpoint import save_pytree

    path = tmp_path_factory.mktemp("sandbox") / "test-gpt.msgpack"
    save_pytree(path, gpt[1])
    return path


def _japply(gpt):
    model, params, _ = gpt
    return lambda e: model.apply({"params": params}, inputs_embeds=e)["logits"]


def _papply(gpt):
    port = gpt[2]
    return lambda e: port(inputs_embeds=e)["logits"]


def _perm(v: int, seed: int = 0) -> np.ndarray:
    return np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), v))


# ---------------------------------------------------------------------------
# anomalous_tokens
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("equal", [False, True], ids=["lloyd", "equal_clusters"])
def test_kmeans_matches_jax(gpt, equal):
    from summer_clip_tpu.sandbox import anomalous_tokens as JA

    table = np.array(gpt[1]["wte"]["embedding"])[:96]
    ja, jc = JA.kmeans(table, 8, seed=3, equal_clusters=equal)
    pa, pc = PA.kmeans(torch.from_numpy(table), 8, equal_clusters=equal,
                       permutation=_perm(len(table), 3))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
    if equal:
        assert np.bincount(pa.numpy(), minlength=8).tolist() == [12] * 8


def test_kmeans_separates_obvious_groups():
    rng = np.random.RandomState(0)
    a = rng.randn(20, 8) * 0.01 + np.array([1.0] + [0.0] * 7)
    b = rng.randn(20, 8) * 0.01 + np.array([0.0, 1.0] + [0.0] * 6)
    assign, centroids = PA.kmeans(torch.from_numpy(np.concatenate([a, b]).astype(np.float32)), 2)
    assign = assign.numpy()
    assert len(set(assign[:20])) == 1 and len(set(assign[20:])) == 1 and assign[0] != assign[20]
    assert tuple(centroids.shape) == (2, 8)


def test_closest_tokens_matches_jax(gpt):
    from summer_clip_tpu.sandbox import anomalous_tokens as JA

    table = np.array(gpt[1]["wte"]["embedding"])
    q = np.random.default_rng(1).standard_normal(32).astype(np.float32)
    jd, ji = JA.closest_tokens(q, table, n=7)
    pd, pi = PA.closest_tokens(torch.from_numpy(q), torch.from_numpy(table), n=7)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)
    d, ids = PA.closest_tokens(torch.eye(6)[3], torch.eye(6), n=2)
    assert int(ids[0]) == 3 and float(d[0]) < 1e-5


def test_greedy_rollout_matches_jax_and_the_growing_loop(gpt):
    """The fixed-shape rollout equals the JAX scan's ids and logits, and a
    loop that regrows the sequence each step (the reference ``model_emb``);
    its gradient reaches the inputs through the final forward only."""
    from summer_clip_tpu.sandbox import anomalous_tokens as JA

    table = np.array(gpt[1]["wte"]["embedding"])
    x = np.random.default_rng(2).standard_normal((2, 3, 32)).astype(np.float32)
    jl, jids, _ = JA.greedy_rollout(_japply(gpt), jnp.asarray(x), jnp.asarray(table), 4)
    papply = _papply(gpt)
    xt = torch.from_numpy(x).requires_grad_(True)
    pl, pids, seq = PA.greedy_rollout(papply, xt, torch.from_numpy(table), 4)
    np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(pl.detach().numpy(), np.asarray(jl), **TOL)
    e, naive = torch.from_numpy(x), []
    with torch.no_grad():
        for _ in range(4):
            ix = papply(e)[:, -1].argmax(-1)
            naive.append(ix)
            e = torch.cat([e, torch.from_numpy(table)[ix][:, None]], dim=1)
    np.testing.assert_array_equal(pids.numpy(), torch.stack(naive, 1).numpy())
    jgrad = jax.grad(lambda v: JA.greedy_rollout(_japply(gpt), v, jnp.asarray(table), 4)[0]
                     [:, -1, 7].sum())(jnp.asarray(x))
    pl[:, -1, 7].sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), **TOL)


def test_confidence_perplexity_matches_jax():
    from summer_clip_tpu.sandbox import anomalous_tokens as JA

    logits = np.random.RandomState(0).randn(2, 5, 7).astype(np.float32)
    got = PA.confidence_perplexity(torch.from_numpy(logits)).numpy()
    np.testing.assert_allclose(got, np.asarray(JA.confidence_perplexity(jnp.asarray(logits))),
                               rtol=1e-6)
    p = torch.softmax(torch.from_numpy(logits), -1).max(-1).values.numpy()
    np.testing.assert_allclose(got, 1.0 / np.prod(p, -1) ** (1.0 / 5) - 1.0, rtol=1e-5)


OPTIMISE_CASES = {
    "random_adam": dict(target_ids=[7], init="random", epochs=6, check_freq=3),
    "kmeans_sgd_window_rep": dict(target_ids=[3, 5], init="kmeans", optimiser="sgd",
                                  output_len=4, penalise_repetition=True, epochs=4, check_freq=2),
    "equal_kmeans_perp": dict(target_ids=[11], init="kmeans", equal_clusters=True,
                              perp_reg=0.5, epochs=4, check_freq=2),
    "local_ce": dict(target_ids=[9], init="local", loss_type="ce", epochs=4, check_freq=2),
}


@pytest.mark.parametrize("case", sorted(OPTIMISE_CASES))
def test_optimise_input_matches_jax(gpt, case):
    from summer_clip_tpu.sandbox import anomalous_tokens as JA

    kw = dict(OPTIMISE_CASES[case], input_len=3, batch_size=2, lr=0.05, seed=1)
    table = np.array(gpt[1]["wte"]["embedding"])
    jlog, plog = [], []
    want = JA.optimise_input(_japply(gpt), table, log_fn=jlog.append, **kw)
    got = PA.optimise_input(_papply(gpt), torch.from_numpy(table), log_fn=plog.append,
                            permutation=_perm(512, 1), **kw)
    np.testing.assert_allclose(got["inputs"].numpy(), np.asarray(want["inputs"]), **TOL)
    np.testing.assert_array_equal(got["nearest_token_ids"], want["nearest_token_ids"])
    for k in ("losses", "nll", "distances", "perplexities"):
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    _same_found(got["found"], want["found"])
    assert (got["epochs_run"], got["final_lr"]) == (want["epochs_run"], want["final_lr"])
    assert [r["epoch"] for r in plog] == [r["epoch"] for r in jlog]
    np.testing.assert_allclose([r["total_loss"] for r in plog], [r["total_loss"] for r in jlog],
                               **TOL)


def _same_found(got, want):
    """Found records: ids and epochs equal, the readings within ``TOL``."""
    assert [(f["input_ids"], f["output_ids"], f["epoch"]) for f in got] == \
        [(f["input_ids"], f["output_ids"], f["epoch"]) for f in want]
    for k in ("loss", "perplexity", "distance"):
        np.testing.assert_allclose([f[k] for f in got], [f[k] for f in want], **TOL, err_msg=k)


def _linear_lms(table: np.ndarray):
    """A 'LM' whose logits are 10 x the cosine to the table, in both packages."""
    tbl = jnp.asarray(table)
    return (lambda e: 10.0 * jnp.einsum("bld,vd->blv", e, tbl),
            lambda e: 10.0 * torch.einsum("bld,vd->blv", e, torch.from_numpy(table)))


def test_success_detection_reinit_and_early_return_match_jax():
    """'local' init starts at the target's embedding: the first check finds
    it, records it, re-initialises the row from the numpy draws and
    ``return_early`` stops the run, in both packages alike."""
    from summer_clip_tpu.sandbox import anomalous_tokens as JA

    rng = np.random.RandomState(0)
    table = rng.randn(16, 8).astype(np.float32)
    table /= np.linalg.norm(table, axis=1, keepdims=True)
    japply, papply = _linear_lms(table)
    kw = dict(target_ids=[7], input_len=2, batch_size=3, epochs=50, lr=0.01, init="local",
              check_freq=5, return_early=True)
    want = JA.optimise_input(japply, table, **kw)
    logs = []
    got = PA.optimise_input(papply, torch.from_numpy(table), log_fn=logs.append, **kw)
    assert got["found"] and got["epochs_run"] == want["epochs_run"] < 50
    _same_found(got["found"], want["found"])
    np.testing.assert_allclose(got["inputs"].numpy(), np.asarray(want["inputs"]), **TOL)
    assert 7 in got["found"][0]["output_ids"] and logs[-1]["num_found"] >= 1


def test_lr_decay_halves_on_plateau_as_jax():
    """Constant logits: constant loss, a plateau, the rate halves on the JAX
    package's schedule."""
    from summer_clip_tpu.sandbox import anomalous_tokens as JA

    table = np.eye(8, dtype=np.float32)
    kw = dict(target_ids=[2], input_len=2, batch_size=2, epochs=60, lr=0.1, dist_reg=0.0,
              init="random", lr_decay=True, check_freq=10, no_reinit=True)
    want = JA.optimise_input(lambda e: jnp.zeros(e.shape[:2] + (8,)), table, **kw)
    got = PA.optimise_input(lambda e: torch.zeros(e.shape[:2] + (8,)), torch.from_numpy(table),
                            permutation=_perm(8), **kw)
    assert got["final_lr"] == want["final_lr"] < 0.1


def test_ce_rejects_multi_token_targets():
    with pytest.raises(ValueError, match="single-token"):
        PA.optimise_input(lambda e: e, torch.eye(4), target_ids=[1, 2], loss_type="ce")


def test_backwards_cli_matches_jax(gpt, tree_file, tmp_path, capsys):
    from summer_clip_tpu.sandbox import anomalous_tokens as JA

    argv = ["--model_name", "test-gpt", "--checkpoint", str(tree_file), "--epochs", "4",
            "--w_freq", "2", "--batch_size", "2", "--input_len", "2", "--init", "local",
            "--run_test_set", "3", "5"]
    want = JA.backwards_main(argv + ["--log", str(tmp_path / "j.jsonl")])
    got = PA.backwards_main(argv + ["--log", str(tmp_path / "p.jsonl"), "--device", "cpu"])
    assert [(r["target"], r["num_found"], r["epochs_run"]) for r in got["runs"]] == \
        [(r["target"], r["num_found"], r["epochs_run"]) for r in want["runs"]]
    recs = [json.loads(line) for line in (tmp_path / "p.jsonl").read_text().splitlines()]
    jrecs = [json.loads(line) for line in (tmp_path / "j.jsonl").read_text().splitlines()]
    assert [r.get("type") for r in recs] == [r.get("type") for r in jrecs]
    np.testing.assert_allclose([r["total_loss"] for r in recs if "total_loss" in r],
                               [r["total_loss"] for r in jrecs if "total_loss" in r], **TOL)
    assert "target=" in capsys.readouterr().out


def test_generate_cli_matches_jax(tree_file, capsys):
    from summer_clip_tpu.sandbox import anomalous_tokens as JA

    argv = ["-m", "test-gpt", "-i", "hello there", "-o", "6", "--checkpoint", str(tree_file)]
    want = JA.main(argv)
    got = PA.main(argv + ["--device", "cpu"])
    assert got == want and len(got) > 0
    out = capsys.readouterr().out
    assert "input tokens" in out and "Output" in out


# ---------------------------------------------------------------------------
# mlm_trigger
# ---------------------------------------------------------------------------
def test_template_fill_matches_jax():
    from summer_clip_tpu.sandbox import mlm_trigger as JM

    jt, pt = JM.TriggerTemplate([5, -1, -1, 9, -2], mask_id=1), PM.TriggerTemplate(
        [5, -1, -1, 9, -2], mask_id=1)
    assert pt.fill([100, 101]).tolist() == np.asarray(jt.fill(jnp.asarray([100, 101]))).tolist() \
        == [[5, 100, 101, 9, 1]]
    assert tuple(pt.fill([1, 2], torch.zeros(3, 1)).shape) == (3, 5)
    assert (pt.predict_pos, pt.trigger_len) == (jt.predict_pos, jt.trigger_len) == (4, 2)
    with pytest.raises(ValueError):
        PM.TriggerTemplate([1, -1])


def test_label_logprob_and_hotflip_match_jax():
    from summer_clip_tpu.sandbox import mlm_trigger as JM

    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 20)).astype(np.float32)
    np.testing.assert_allclose(PM.label_logprob(torch.from_numpy(logits), [2, 5]).numpy(),
                               np.asarray(JM.label_logprob(jnp.asarray(logits), [2, 5])),
                               rtol=1e-6)
    table = rng.standard_normal((20, 4)).astype(np.float32)
    g = rng.standard_normal(4).astype(np.float32)
    np.testing.assert_array_equal(
        PM.hotflip_candidates(torch.from_numpy(g), torch.from_numpy(table), 5),
        JM.hotflip_candidates(jnp.asarray(g), jnp.asarray(table), 5))


def test_trigger_search_step_matches_jax():
    """Score = the slot tokens' similarity to token 7: both packages draw the
    same slots and reach [7, 7]."""
    from summer_clip_tpu.sandbox import mlm_trigger as JM

    table = np.random.RandomState(0).randn(16, 4).astype(np.float32)
    target = table[7]

    def score_fn(ids):
        return float(np.sum(table[np.asarray(ids)] @ target))

    jtrig, ptrig = [1, 2], [1, 2]
    jrng, prng = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(6):
        want = JM.trigger_search_step(
            jtrig, lambda ids: jnp.broadcast_to(jnp.asarray(target), (len(ids), 4)), score_fn,
            jnp.asarray(table), num_cands=16, rng=jrng)
        got = PM.trigger_search_step(
            ptrig, lambda ids: torch.from_numpy(target).expand(len(ids), 4), score_fn,
            torch.from_numpy(table), num_cands=16, rng=prng)
        assert (got["slot"], got["accepted"]) == (want["slot"], want["accepted"])
        assert ptrig == jtrig
    assert ptrig == [7, 7]


# ---------------------------------------------------------------------------
# create_trigger
# ---------------------------------------------------------------------------
def _char_encode(text):
    """Toy tokenizer: one id per char, ids 1..127 (0 reserved for pad/mask)."""
    return [max(1, ord(c) % 128) for c in text if not c.isspace()] or [1]


def test_templatizer_and_loaders_match_jax(tmp_path):
    from summer_clip_tpu.sandbox import create_trigger as JC

    kw = dict(mask_id=0, label_map={"0": "a", "1": "b"}, max_len=16)
    jt = JC.Templatizer("[T] [T] xy {sentence} [P]", _char_encode, **kw)
    pt = PC.Templatizer("[T] [T] xy {sentence} [P]", _char_encode, **kw)
    ex = {"sentence": "qr", "label": "1"}
    for a, b in zip(pt(ex), jt(ex)):
        np.testing.assert_array_equal(a, b)
    assert np.flatnonzero(pt(ex).predict_mask)[0] == 6
    tsv, jl, re = tmp_path / "d.tsv", tmp_path / "d.jsonl", tmp_path / "re.jsonl"
    tsv.write_text("text\tlabel\nab\tx\ncd\ty\n")
    jl.write_text('{"text": "ab", "label": "x"}\n{"text": "' + "z" * 40 + '", "label": "y"}\n')
    re.write_text(json.dumps({"label": "x", "evidences": [
        {"obj_surface": "cat", "masked_sentence": "a [MASK] sat"},
        {"obj_surface": "dog", "masked_sentence": "the [MASK] ran"}]}) + "\n"
        + json.dumps({"label": "y"}) + "\n")
    for path, template, use_ctx, n in ((tsv, "[T] {text} [P]", False, 2),
                                      (jl, "[T] {text} [P]", False, 1),
                                      (re, "[T] {context} [P]", True, 1)):
        want = JC.load_trigger_dataset(path, JC.Templatizer(template, _char_encode, 0, max_len=32),
                                       use_ctx=use_ctx, rng=np.random.default_rng(4))
        got = PC.load_trigger_dataset(path, PC.Templatizer(template, _char_encode, 0, max_len=32),
                                      use_ctx=use_ctx, rng=np.random.default_rng(4))
        assert len(got) == len(want) == n
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def test_label_loss_accuracy_and_filter_match_jax():
    from summer_clip_tpu.sandbox import create_trigger as JC

    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, 12)).astype(np.float32) * 3
    rows = [JC.encode_label(None, [2, 3]), JC.encode_label(None, [5]), JC.encode_label(None, [7])]
    gold = np.stack([rows[i % 3] for i in range(6)])
    np.testing.assert_allclose(PC.label_loss(torch.from_numpy(logits), torch.from_numpy(gold)),
                               np.asarray(JC.label_loss(jnp.asarray(logits), jnp.asarray(gold))),
                               rtol=1e-6)
    jacc, pacc = JC.AccuracyFn(rows, ["A", "B", "C"]), PC.AccuracyFn(rows, ["A", "B", "C"])
    np.testing.assert_array_equal(pacc(torch.from_numpy(logits), torch.from_numpy(gold)).numpy(),
                                  np.asarray(jacc(jnp.asarray(logits), jnp.asarray(gold))))
    assert pacc.predict(torch.from_numpy(logits)) == jacc.predict(jnp.asarray(logits))
    decode = {1: " Cap", 2: " low", 3: "x"}.get
    kw = dict(label_ids=[np.asarray([3])], special_ids=[0],
              decode_fn=lambda ids: decode(ids[0], ""))
    np.testing.assert_array_equal(PC.build_token_filter(5, **kw), JC.build_token_filter(5, **kw))


def _trigger_rows(n: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    return [{"text": "".join(chr(97 + rng.randint(0, 4)) for _ in range(3)),
             "label": str(rng.randint(0, 2))} for _ in range(n)]


def test_trigger_search_matches_jax(gpt):
    """The whole loop on test-gpt: the same slots, acceptances, candidates'
    metrics and best trigger as the JAX search."""
    from summer_clip_tpu.sandbox import create_trigger as JC

    model, params, port = gpt
    table = params["wte"]["embedding"]

    def enc(text):
        return [max(1, ord(c) % 512) for c in text if not c.isspace()] or [1]

    label_map = {"0": [7], "1": [9]}
    rows = _trigger_rows(32)
    kw = dict(iters=3, bsz=4, accumulation_steps=2, num_cand=6, eval_size=8, seed=0)
    results = []
    for mod, fn, tbl in ((JC, _japply(gpt), table),
                         (PC, _papply(gpt), torch.from_numpy(np.asarray(table)))):
        t = mod.Templatizer("[T] [T] {text} [P]", enc, mask_id=0, label_map=label_map, max_len=12)
        search = mod.TriggerSearch(fn, tbl, t.num_trigger_tokens, causal=True,
                                   evaluation_fn=mod.AccuracyFn.from_label_map(enc, label_map))
        results.append(search.search([t(r) for r in rows[:24]], [t(r) for r in rows[24:]], **kw))
    want, got = results
    assert len(got["history"]) == len(want["history"]) == 4
    for g, w in zip(got["history"], want["history"]):
        assert {k: v for k, v in g.items() if "metric" not in k} == \
            {k: v for k, v in w.items() if "metric" not in k}
        for k in ("train_metric", "dev_metric"):
            if k in w:
                np.testing.assert_allclose(g[k], w[k], **TOL)
    assert got["best"]["trigger_ids"] == want["best"]["trigger_ids"]
    assert got["final_trigger_ids"] == want["final_trigger_ids"]


def test_create_trigger_cli_matches_jax(tree_file, tmp_path, capsys):
    """Both CLIs over one tsv, the JAX package's tree, ``--filter`` and the
    log-prob metric (no label map)."""
    from summer_clip_tpu.sandbox import create_trigger as JC

    rows = _trigger_rows(20, seed=1)
    for name, part in (("train", rows[:12]), ("dev", rows[12:])):
        (tmp_path / f"{name}.tsv").write_text(
            "text\tlabel\n" + "".join(f"{r['text']}\t{'yes' if r['label'] == '1' else 'no'}\n"
                                      for r in part))
    argv = ["--train", str(tmp_path / "train.tsv"), "--dev", str(tmp_path / "dev.tsv"),
            "--template", "[T] [T] {text} [P]", "--model", "test-gpt",
            "--checkpoint", str(tree_file), "--iters", "2", "--bsz", "4",
            "--accumulation-steps", "2", "--num-cand", "4", "--max-len", "16", "--filter"]
    want = JC.main(argv + ["--out", str(tmp_path / "j.json")])
    got = PC.main(argv + ["--out", str(tmp_path / "p.json"), "--device", "cpu"])
    assert got["best"]["trigger_ids"] == want["best"]["trigger_ids"]
    assert got["best"]["trigger_text"] == want["best"]["trigger_text"]
    np.testing.assert_allclose(got["best"]["dev_metric"], want["best"]["dev_metric"], **TOL)
    assert [h["slot"] for h in got["history"][1:]] == [h["slot"] for h in want["history"][1:]]
    assert json.loads((tmp_path / "p.json").read_text())["best"]["trigger_ids"] == \
        got["best"]["trigger_ids"]
    assert '"type": "best"' in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the utils alias and core/profiling
# ---------------------------------------------------------------------------
def test_utils_alias_has_the_references_names():
    import summer_clip_tpu.utils as jutils

    import summer_clip_torch.utils as putils

    names = ["hydra_utils", "log_utils", "profiling", "set_random_state", "train_utils",
             "BaseTrainer", "run_trainer", "datasets"]
    for name in names:
        assert hasattr(jutils, name)
        obj = getattr(putils, name)
        assert getattr(obj, "__module__", getattr(obj, "__name__", "")).startswith(
            "summer_clip_torch."), name
    assert putils.datasets.__name__ == "summer_clip_torch.data.views"
    assert putils.train_utils.adamw is not None and callable(putils.set_random_state)


def test_profiling_trace(tmp_path):
    from summer_clip_torch.core import profiling

    with profiling.trace(str(tmp_path / "trace"), enabled=False) as prof:
        assert prof is None
    assert not (tmp_path / "trace").exists()
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.span("outer"):
            with profiling.span("mm"):
                torch.randn(32, 32) @ torch.randn(32, 32)
            profiling.count("products", 2)
    assert any("mm" in e.key for e in prof.key_averages())
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in str(e.get("name", "")) for e in trace["traceEvents"])
    lines = [json.loads(line) for line in
             (tmp_path / "trace" / "spans.jsonl").read_text().splitlines()]
    assert [(x["name"], x["parent"], x["device_ms"]) for x in lines[:-1]] == [
        ("outer", -1, None), ("mm", 0, None)]
    assert all(0 < x["start_ns"] <= x["end_ns"] for x in lines[:-1])
    assert lines[-1] == {"counters": {"products": 2}, "dropped": 0}
    profiling.reset()
