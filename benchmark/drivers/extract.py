"""Extraction: ``apps.common.extract_image_features`` over splits of seed-made
images, as ``save_features`` ships them (uint8, normalized on the device).

Set-up draws the configuration's weights from the seed on the card, writes
them as an OpenAI-layout checkpoint in the run's scratch directory and builds
the session with the port's own ``create_clip_session``, builds a pool of
seed-made images on the host, and warms every shape up with a short split.
The window calls the extraction over whole splits of ``split_images`` rows,
each batch a slice of the pool (a split starts where the last one ended,
cycling), until ``--seconds`` have passed; the rate is over every image of
every split over the window's seconds. The session is wrapped by an object of
the harness's that records a span around each batch's encode call.

The check compares a sample of the returned rows, drawn from the seed (the
tail batch's last row always among them), with the plain tower on the same
images in the precision the configuration states (bf16 activations and
products, float32 sums, LayerNorm and softmax): the systematic error of the
features (``bias_rel``), the largest over groups of 128 sampled rows; for
the sampled rows and for every row of the window's first and last split, the
nearest reference row, which has to be the row's own image's
(``rows_misplaced``: a swapped or a wrong row); and every split's rows and
order. A row's own error, and any error against the float32 tower, read
alike for the program and its int8 control (``PERF.md``), so they separate
nothing.
"""

from __future__ import annotations

import dataclasses
import sys
import time
import typing as tp
from pathlib import Path

import numpy as np
import torch

from benchmark import seeds, traffic, weights
from benchmark.harness import Check, Context, sync
from benchmark.reference import clip as ref_clip
from benchmark.weights import clip_state_dict

GROUP_ROWS = 128     # compared rows a group of ``feat_bias_rel``


def session(config: dict, seed: int, device, scratch, quant: tp.Optional[str] = None):
    """The port's session over the seed's weights, through its own loading
    path: an OpenAI-layout checkpoint in the run's scratch directory, read by
    ``create_clip_session`` (the text tower, which extraction never runs, as
    zeros)."""
    from summer_clip_torch.apps.common import create_clip_session

    ckpt = weights.write_checkpoint(config, seed, device, Path(scratch) / "clip.pt",
                                    towers=("image",))
    sess = create_clip_session(config["model_name"], checkpoint_path=str(ckpt), device=device,
                               quant=quant)
    if sess.cfg.name != config["model_name"]:
        raise ValueError(f"the checkpoint loaded as {sess.cfg.name}, not {config['model_name']}")
    return sess


class SessionSpy:
    """The session as ``extract_image_features`` uses it, with a span around
    each encode call (the host's time to enqueue a batch's tower)."""

    def __init__(self, session, spans):
        self._session, self._spans = session, spans
        self.mesh, self.device = session.mesh, session.device

    def encode_image(self, images):
        with self._spans.span("encode"):
            return self._session.encode_image(images)


class PoolBatcher:
    """Split ``split`` of ``rows`` images in batches of ``batch``; row ``i``
    is pool image ``(split * rows + i) % len(pool)``; the tail batch padded."""

    def __init__(self, pool: np.ndarray, split: int, rows: int, batch: int):
        self.pool, self.split, self.rows, self.batch = pool, split, rows, batch

    def __iter__(self):
        from summer_clip_torch.data.loader import Batch, pad_to_batch

        n_pool, b = self.pool.shape[0], self.batch
        for s in range(0, self.rows, b):
            count = min(b, self.rows - s)
            p0 = (self.split * self.rows + s) % n_pool
            if p0 + count <= n_pool:
                images = self.pool[p0:p0 + count]
            else:
                images = self.pool[(p0 + np.arange(count)) % n_pool]
            idx = np.arange(s, s + count, dtype=np.int32)
            yield Batch(pad_to_batch(images, b), np.zeros(b, np.int32), pad_to_batch(idx, b),
                        pad_to_batch(np.ones(count, bool), b))


@dataclasses.dataclass
class State:
    session: tp.Any
    spy: SessionSpy
    pool: np.ndarray
    rows: np.ndarray                       # sampled rows of every split
    results: tp.List[tp.Tuple[int, bool, np.ndarray]] = dataclasses.field(default_factory=list)
    whole_splits: tp.Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)


def sample_rows(seed: int, rows: int, count: int) -> np.ndarray:
    rng = np.random.default_rng(seeds.derive(seed, "check_rows"))
    pick = rng.choice(rows - 1, size=count - 1, replace=False)
    return np.sort(np.append(pick, rows - 1))


def setup(ctx: Context, quant: tp.Optional[str] = None) -> State:
    from summer_clip_torch.apps.common import extract_image_features

    t = ctx.workload["traffic"]
    sess = session(ctx.config, ctx.seed, ctx.device, ctx.scratch, quant=quant)
    pool = traffic.image_pool(ctx.seed, t["pool_images"], ctx.config["image_resolution"],
                              ctx.device)
    spy = SessionSpy(sess, ctx.spans)
    warm = PoolBatcher(pool, 0, t["batch"] + 1, t["batch"])   # a full and a padded batch
    extract_image_features(spy, warm)
    sync(ctx.device)
    ctx.spans.items.clear()
    return State(sess, spy, pool, sample_rows(ctx.seed, t["split_images"], t["check_rows"]))


def window(ctx: Context, st: State) -> dict:
    from summer_clip_torch.apps.common import extract_image_features

    t = ctx.workload["traffic"]
    rows, batch = t["split_images"], t["batch"]
    want = np.arange(rows)
    t0 = time.perf_counter()
    split = 0
    while True:
        with ctx.spans.span("extract"):
            feats, _, idx = extract_image_features(st.spy, PoolBatcher(st.pool, split, rows, batch))
        ctx.spans.count("batches", -(-rows // batch))
        whole = feats.shape[0] == rows and np.array_equal(idx, want)
        st.results.append((split, whole, feats[st.rows] if whole else feats[:0]))
        if whole:                          # every row of the first split and of the last
            st.whole_splits = {k: v for k, v in st.whole_splits.items() if k == 0}
            st.whole_splits[split] = feats
        split += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    elapsed = time.perf_counter() - t0
    ctx.spans.count("splits", split)
    return {"seconds": elapsed, "attempted": split,
            "end_to_end": {"images_per_s": split * rows / elapsed}}


def release(ctx: Context, st: State) -> dict:
    out = {"pool": st.pool, "rows": st.rows, "results": st.results,
           "whole_splits": st.whole_splits}
    del st.session, st.spy
    return out


def reference_features(ctx: Context, images: np.ndarray,
                       dtype: tp.Optional[torch.dtype] = None) -> np.ndarray:
    """The plain tower over ``images`` (uint8 NHWC), 32 at a time, in the
    configuration's precision (``dtype`` to override)."""
    dtype = dtype or getattr(torch, ctx.config["dtype"])
    ref_clip.no_tf32()
    sd = clip_state_dict(ctx.config, ctx.seed, ctx.device, towers=("image",))
    if dtype == torch.float32:
        sd = {k: v.float() for k, v in sd.items()}
    out = []
    with torch.inference_mode():
        for s in range(0, images.shape[0], 32):
            x = torch.from_numpy(images[s:s + 32]).to(ctx.device)
            out.append(ref_clip.encode_image(sd, x, patch=ctx.config["vision_patch_size"],
                                             heads=ctx.config["vision_heads"],
                                             dtype=dtype).cpu().numpy())
    return np.concatenate(out)


def bias_rel(program: np.ndarray, reference: np.ndarray) -> float:
    """``|mean(program - reference)| / mean(|reference|)`` over rows: the
    systematic part of the error. bf16 rounding differs from row to row and
    averages out over many rows; a changed function (the int8 towers' weights,
    a wrong kernel) shifts every row alike and stays."""
    d = (program.astype(np.float64) - reference).mean(axis=0)
    return float(np.linalg.norm(d) / np.linalg.norm(reference.astype(np.float64), axis=1).mean())


def group_bias(program: np.ndarray, reference: np.ndarray, rows: int = GROUP_ROWS) -> float:
    """The largest ``bias_rel`` over consecutive groups of ``rows`` compared
    rows (a shorter tail joins the group before it), so that one wrong row
    weighs as much in a long window as in one split."""
    n = program.shape[0]
    starts = list(range(0, max(n - rows, 0) + 1, rows)) if n >= rows else [0]
    ends = starts[1:] + [n]
    return max(bias_rel(program[a:b], reference[a:b]) for a, b in zip(starts, ends))


def misplaced(program: np.ndarray, reference: np.ndarray, own: np.ndarray, device
              ) -> tp.Tuple[np.ndarray, float]:
    """Rows whose nearest reference row is another image's, and the least
    ratio over rows of the distance to the nearest other image's reference
    over the distance to the row's own (how far a sound run is from a
    misplaced row)."""
    r = torch.from_numpy(reference).to(device, torch.float32)
    wrong, ratios = [], []
    for s in range(0, program.shape[0], 8192):
        p = torch.from_numpy(program[s:s + 8192]).to(device, torch.float32)
        d = torch.cdist(p, r)
        rows = torch.arange(p.shape[0], device=device)
        mine = torch.from_numpy(own[s:s + 8192]).to(device)
        own_d = d[rows, mine].clone()
        d[rows, mine] = float("inf")
        other = d.min(dim=1).values
        wrong.append((other < own_d).cpu().numpy())
        ratios.append((other / own_d.clamp_min(1e-30)).min().item())
    return np.concatenate(wrong), min(ratios)


def check(ctx: Context, payload: dict) -> tp.Tuple[tp.List[Check], int]:
    t, limit = ctx.workload["traffic"], ctx.workload["limits"]["feat_bias_rel"]
    pool, rows, results = payload["pool"], payload["rows"], payload["results"]
    n_pool, n = pool.shape[0], t["split_images"]
    wanted = sorted({(split * n + r) % n_pool for split, whole, _ in results if whole
                     for r in (range(n) if split in payload["whole_splits"] else rows)})
    if len(wanted) > t["reference_images"]:
        rng = np.random.default_rng(seeds.derive(ctx.seed, "check_images"))
        wanted = sorted(rng.choice(wanted, t["reference_images"], replace=False).tolist())
    where = np.full(n_pool, -1)
    where[wanted] = np.arange(len(wanted))
    ref = reference_features(ctx, pool[wanted])
    # the sampled rows of every split: the systematic error and the rows' places
    got, own, of_split = [], [], []
    for i, (split, whole, feats) in enumerate(results):
        if whole:
            mine = where[(split * n + rows) % n_pool]
            keep = mine >= 0
            got.append(feats[keep])
            own.append(mine[keep])
            of_split.append(np.full(int(keep.sum()), i))
    n_sampled = sum(len(o) for o in own)
    # every row of the first and the last split: the rows' places
    index = {split: i for i, (split, _, _) in enumerate(results)}
    for split, feats in payload["whole_splits"].items():
        mine = where[(split * n + np.arange(n)) % n_pool]
        keep = mine >= 0
        got.append(feats[keep])
        own.append(mine[keep])
        of_split.append(np.full(int(keep.sum()), index[split]))
    if got and n_sampled:
        got_a, own_a, split_a = np.concatenate(got), np.concatenate(own), np.concatenate(of_split)
        bias = group_bias(got_a[:n_sampled], ref[own_a[:n_sampled]])
        wrong, margin = misplaced(got_a, ref, own_a, ctx.device)
        print(f"info rows compared {got_a.shape[0]} ({n_sampled} sampled), reference images "
              f"{len(wanted)}; least ratio of the distance to the nearest other image's "
              f"reference over the row's own: {margin!r}", file=sys.stderr)
    else:
        bias, wrong, split_a = float("inf"), np.zeros(0, bool), np.zeros(0, int)
    broken = sum(not whole for _, whole, _ in results)
    if np.isfinite(bias) and bias <= limit:
        failed = broken + len(set(split_a[wrong].tolist()))
    else:
        failed = len(results)
    return ([Check("feat_bias_rel", bias, limit),
             Check("rows_misplaced", float(wrong.sum()), 0.0),
             Check("splits_malformed", float(broken), 0.0)], failed)


def control(ctx: Context) -> tp.List[Check]:
    """The program's own lower precision (int8 towers) in its place, over
    one split."""
    st = setup(ctx, quant="int8")
    seconds, ctx.seconds = ctx.seconds, 0.0
    window(ctx, st)
    ctx.seconds = seconds
    payload = release(ctx, st)
    del st
    torch.cuda.empty_cache()
    return check(ctx, payload)[0]
