"""CLIP-search: ``apps.image_attention.ImageAttention.train_loop`` over a
seed-made feature store, after the app's own set-up.

Set-up writes what the app reads under the run's scratch directory: a
CoOp-format split file (``classes`` names, ``train_per_class`` and
``test_per_class`` rows a class, in an order drawn from the seed), a feature
store with the test features, the cache's features and its zero-shot outs
(``traffic.pseudo_outs``), and a checkpoint in OpenAI's layout with the
configuration's text tower drawn from the seed (the image tower, which the
app never runs, as one-element zero views). Then the app is composed from
the port's own ``image_attention`` config with the cell's overrides (one
selection, ``all_logits``; the grid as the config's files give it), set up in
the scratch directory (it reads the store, encodes the prompts with the text
tower, makes the cache resident) and warmed up by one pass. The window runs
whole passes until ``--seconds`` have passed; the rate is every (value, beta,
alpha) point of every pass over the window's seconds.

The check reads every record the passes logged and compares each top-1 and
top-5 accuracy, and the zero-shot record's, with the plain reference's: the
text tower in float32 over the same tokens, the zero-shot logits, the soft
values, the whole cache's weights and the blends.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import typing as tp
from pathlib import Path

import numpy as np
import torch

from benchmark import traffic, weights
from benchmark.harness import Check, Context, sync
from benchmark.reference import cache as ref_cache
from benchmark.reference import clip as ref_clip
from benchmark.reference import tokenizer as ref_tok

TEST_KEY, CACHE_KEY = "bench_test", "bench_cache"


@dataclasses.dataclass
class Data:
    test: np.ndarray          # (Nt, D) f32, not normalized
    test_labels: np.ndarray   # (Nt,)
    cache: np.ndarray         # (Nc, D) f32
    outs: np.ndarray          # (Nc, C) f32


def make_data(ctx: Context) -> tp.Tuple[Data, np.ndarray]:
    """The data, and the cache rows' true labels (the split file's)."""
    t = ctx.workload["traffic"]
    dev, c, d = ctx.device, len(t["classnames"]), ctx.config["embed_dim"]
    gen = traffic.generator(ctx.seed, "clip_search", dev)
    means = traffic.unit_rows(gen, c, d, dev)
    shared = t["shared_direction"] * traffic.unit_rows(gen, 1, d, dev)[0]
    test_labels = traffic.balanced_labels(gen, c, t["test_per_class"], dev)
    cache_labels = traffic.balanced_labels(gen, c, t["train_per_class"], dev)
    test = traffic.class_structured(gen, means, test_labels, t["feature_noise"], shared)
    cache = traffic.class_structured(gen, means, cache_labels, t["feature_noise"], shared)
    outs = traffic.pseudo_outs(gen, cache_labels, c, **t["outs"])
    return Data(test.cpu().numpy(), test_labels.cpu().numpy(), cache.cpu().numpy(),
                outs.cpu().numpy()), cache_labels.cpu().numpy()


def write_inputs(ctx: Context, data: Data, cache_labels: np.ndarray) -> tp.List[str]:
    """The split file, the store and the checkpoint; the app's overrides."""
    from summer_clip_torch.store import FeatureStore

    t = ctx.workload["traffic"]
    root = ctx.scratch
    names = t["classnames"]
    split_dir = root / t["dataset_dir"]
    split_dir.mkdir(parents=True)

    def rows(labels, tag):
        return [[f"{names[y]}/{tag}_{i}.jpg", int(y), names[y]] for i, y in enumerate(labels)]

    (split_dir / t["split_file"]).write_text(json.dumps(
        {"train": rows(cache_labels, "train"), "val": [], "test": rows(data.test_labels, "test")}))
    store = FeatureStore(root / "store")
    store.save(TEST_KEY, features=data.test)
    store.save(CACHE_KEY, features=data.cache, outs=data.outs)
    ckpt = weights.write_checkpoint(ctx.config, ctx.seed, ctx.device, root / "clip.pt",
                                    towers=("text",))
    return [f"clip={t['clip_conf']}", f"clip.checkpoint_path={ckpt}",
            f"dataset_name={t['dataset']}", f"path.cache_dir={root}",
            f"store.root={root / 'store'}", f"data.features_key={TEST_KEY}",
            f"cache.features_key={CACHE_KEY}", f"cache.outs_key={CACHE_KEY}",
            f"meta.device={ctx.device}", *t["overrides"],
            f"cache_weights_strategy.beta={json.dumps(t['betas'])}",
            f"cache.alpha={json.dumps(t['alphas'])}",
            f"cache_value_strategy.scale={json.dumps(t['value_scales'])}",
            f"cache_value_strategy.clip_scale={t['clip_scale']}",
            f"prompting.templates={json.dumps(t['templates'])}"]


@dataclasses.dataclass
class State:
    app: tp.Any
    data: Data
    run_dir: Path
    old_cwd: str
    skip_records: int


def records(run_dir: Path) -> tp.List[dict]:
    path = run_dir / "records.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()] if path.exists() else []


def setup(ctx: Context) -> State:
    import summer_clip_torch
    from summer_clip_torch.apps.image_attention import ImageAttention
    from summer_clip_torch.core import config as C

    t = ctx.workload["traffic"]
    data, cache_labels = make_data(ctx)
    overrides = write_inputs(ctx, data, cache_labels)
    cfg = C.compose(Path(summer_clip_torch.__file__).parent / "conf", "image_attention", overrides)
    cfg.pop("hydra", None)
    for name in list(cfg.cache_strategies.keys()):
        if name not in t["selections"]:
            del cfg.cache_strategies[name]
    run_dir = ctx.scratch / "run"
    run_dir.mkdir()
    old_cwd = os.getcwd()
    os.chdir(run_dir)
    app = ImageAttention(cfg)
    app.setup()
    app.train_loop()
    sync(ctx.device)
    return State(app, data, run_dir, old_cwd, len(records(run_dir)))


def points_per_pass(ctx: Context) -> int:
    t = ctx.workload["traffic"]
    return len(t["selections"]) * len(t["value_scales"]) * len(t["betas"]) * len(t["alphas"])


def window(ctx: Context, st: State) -> dict:
    t0 = time.perf_counter()
    passes = 0
    while True:
        with ctx.spans.span("pass"):
            st.app.train_loop()
        passes += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    elapsed = time.perf_counter() - t0
    ctx.spans.count("passes", passes)
    return {"seconds": elapsed, "attempted": passes,
            "end_to_end": {"sweep_points_per_s": passes * points_per_pass(ctx) / elapsed}}


def release(ctx: Context, st: State) -> dict:
    os.chdir(st.old_cwd)
    st.app.logger.finish()
    recs = records(st.run_dir)[st.skip_records:]
    del st.app
    return {"data": st.data, "records": recs}


def reference_records(ctx: Context, data: Data, dtype: torch.dtype = torch.float32) -> dict:
    """The reference's zero-shot accuracies and its (value, beta, alpha)
    grid of accuracies."""
    t = ctx.workload["traffic"]
    dev = ctx.device
    ref_clip.no_tf32()
    sd = weights.clip_state_dict(ctx.config, ctx.seed, dev, towers=("text",))
    if dtype == torch.float32:
        sd = {k: v.float() for k, v in sd.items()}
    prompts = [tpl.format(n.replace("_", " ")) for n in t["classnames"] for tpl in t["templates"]]
    tokens = torch.from_numpy(ref_tok.tokenize(prompts)).to(dev)
    with torch.inference_mode():
        text = torch.cat([ref_clip.encode_text(sd, tokens[s:s + 256],
                                               heads=ctx.config["text_heads"], dtype=dtype)
                          for s in range(0, tokens.shape[0], 256)])
        classifier = ref_cache.zeroshot_classifier(text, len(t["classnames"]))
        test = ref_cache.l2n(torch.from_numpy(data.test).to(dev))
        clip_logits = 100.0 * test @ classifier.t()
        labels = torch.from_numpy(data.test_labels).to(dev).long()
        zero = ref_cache.topk_accuracy(clip_logits, labels)
        grid = ref_cache.clip_search_grid(test, labels, clip_logits,
                                          torch.from_numpy(data.cache).to(dev),
                                          torch.from_numpy(data.outs).to(dev),
                                          t["value_scales"], t["clip_scale"], t["betas"],
                                          t["alphas"], dtype=dtype)
    return {"zero_shot": zero, "grid": grid}


def compare(ctx: Context, recs: tp.Sequence[dict], ref: dict
            ) -> tp.Tuple[tp.List[Check], int]:
    t, limits = ctx.workload["traffic"], ctx.workload["limits"]
    per_pass = points_per_pass(ctx)
    results = [r for r in recs if r.get("type") == "searcher_result"]
    zeros = [r for r in recs if r.get("type") == "zero_shot"]
    gap, failed = 0.0, 0
    passes = max(len(zeros), 1)
    bad_passes = set()
    for i, r in enumerate(results):
        try:
            vi = t["value_scales"].index(r["cache_value_strategy"]["scale"])
            bi = t["betas"].index(r["cache_weights_strategy"]["beta"])
            ai = t["alphas"].index(r["alpha"])
            want = ref["grid"][vi, bi, ai]
            g = max(abs(r["acc1"] - want[0]), abs(r["acc5"] - want[1]))
        except (KeyError, ValueError, TypeError):
            g = float("inf")
        if g > limits["acc_gap_pp"]:
            bad_passes.add(i // per_pass)
        gap = max(gap, g)
    for i, r in enumerate(zeros):
        g = max(abs(r["acc1"] - ref["zero_shot"][0]), abs(r["acc5"] - ref["zero_shot"][1]))
        if g > limits["acc_gap_pp"]:
            bad_passes.add(i)
        gap = max(gap, g)
    missing = abs(len(results) - len(zeros) * per_pass) + (0 if zeros else 1)
    failed = len(bad_passes) + (passes if missing else 0)
    return ([Check("acc_gap_pp", float(gap), limits["acc_gap_pp"]),
             Check("records_missing", float(missing), 0.0)], min(failed, passes))


def check(ctx: Context, payload: dict) -> tp.Tuple[tp.List[Check], int]:
    return compare(ctx, payload["records"], reference_records(ctx, payload["data"]))


def as_records(ctx: Context, ref: dict) -> tp.List[dict]:
    """A reference's grid as the records one pass of the app logs."""
    t = ctx.workload["traffic"]
    recs = [{"type": "zero_shot", "acc1": ref["zero_shot"][0], "acc5": ref["zero_shot"][1]}]
    for vi, scale in enumerate(t["value_scales"]):
        for bi, beta in enumerate(t["betas"]):
            for ai, alpha in enumerate(t["alphas"]):
                a1, a5 = ref["grid"][vi, bi, ai]
                recs.append({"type": "searcher_result", "cache_value_strategy": {"scale": scale},
                             "cache_weights_strategy": {"beta": beta}, "alpha": alpha,
                             "acc1": float(a1), "acc5": float(a5)})
    return recs


def control(ctx: Context) -> tp.List[Check]:
    """The reference in bf16 in the program's place."""
    data, _ = make_data(ctx)
    low = as_records(ctx, reference_records(ctx, data, torch.bfloat16))
    return compare(ctx, low, reference_records(ctx, data))[0]
