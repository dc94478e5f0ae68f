"""Tip-Adapter's (beta, alpha) search: ``methods.tip.search_hp`` over a
seed-made ImageNet-scale few-shot cache, called as ``apps/tip_adapter.py``
calls it (features, keys and one-hot values as host arrays, the zero-shot
logits on the card, ``cache_labels`` so the search takes the label kernels).

Set-up draws class means, test features, a class-grouped cache of
``shots`` keys a class and a text classifier near the means (so zero-shot
accuracy lies far from chance), all on the card from the seed, and warms the
search up over one chunk of 16 betas and one of 8 (every launch shape of the
full grid). The window runs whole searches until ``--seconds`` have passed;
the rate is every (beta, alpha) point of every search over the window's
seconds.

Each search runs under a ``GridSpy``: wrappers around the two names
``search_hp`` looks up in its module, which record the betas it hands the
cache kernel (those whose logits come back) and the alphas of the grid it
blends over. The program's files are not changed.

The check runs the plain float32 grid (``reference/cache.py``) over the same
inputs and compares every accuracy the searches returned or logged with the
reference's at that point (the returned point has to be the last one
logged), and counts the (beta, alpha) points of the grid a search left out
(``grid_points_missing``), since the rate credits every search with the
whole grid.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import typing as tp

import numpy as np
import torch

from benchmark import traffic
from benchmark.harness import Check, Context, sync
from benchmark.reference import cache as ref_cache
from benchmark.reference.clip import no_tf32


@dataclasses.dataclass
class Inputs:
    features: np.ndarray          # (Nt, D) f32, normalized
    labels: np.ndarray            # (Nt,) int64
    clip_logits: torch.Tensor     # (Nt, C) f32 on the card
    keys: np.ndarray              # (Nc, D) f32, normalized, class-grouped
    values: np.ndarray            # (Nc, C) f32 one-hot
    key_labels: np.ndarray        # (Nc,) int32


def make_inputs(ctx: Context) -> Inputs:
    t = ctx.workload["traffic"]
    dev, c, d = ctx.device, t["classes"], ctx.config["embed_dim"]
    gen = traffic.generator(ctx.seed, "tip", dev)
    means = traffic.unit_rows(gen, c, d, dev)
    labels = traffic.balanced_labels(gen, c, t["test_per_class"], dev)
    feats = ref_cache.l2n(traffic.class_structured(gen, means, labels, t["feature_noise"]))
    key_labels = traffic.balanced_labels(gen, c, t["shots"], dev, shuffle=False)
    keys = ref_cache.l2n(traffic.class_structured(gen, means, key_labels, t["feature_noise"]))
    text = ref_cache.l2n(traffic.class_structured(gen, means, torch.arange(c, device=dev),
                                                  t["text_noise"]))
    no_tf32()
    clip_logits = 100.0 * feats @ text.t()
    values = np.zeros((key_labels.shape[0], c), np.float32)
    kl = key_labels.cpu().numpy()
    values[np.arange(kl.shape[0]), kl] = 1.0
    return Inputs(feats.cpu().numpy(), labels.cpu().numpy(), clip_logits, keys.cpu().numpy(),
                  values, kl.astype(np.int32))


@dataclasses.dataclass
class State:
    inputs: Inputs
    searches: tp.List[dict] = dataclasses.field(default_factory=list)


class GridSpy:
    """What one search covers: the betas whose cache logits the cache kernel
    returned, and the alphas of the grid the search blends them over."""

    def __init__(self) -> None:
        self.betas: tp.List[float] = []
        self.alphas: tp.List[float] = []

    @contextlib.contextmanager
    def watching(self):
        from summer_clip_torch.methods import tip

        kernel, grid = tip.cache_attention_auto, tip.beta_alpha_grid

        def counted_kernel(test, keys, values, betas, *args, **kwargs):
            out = kernel(test, keys, values, betas, *args, **kwargs)
            if out.shape[0] == len(betas):
                self.betas.extend(float(b) for b in betas)
            return out

        def counted_grid(*args, **kwargs):
            betas, alphas = grid(*args, **kwargs)
            self.alphas = [float(a) for a in alphas]
            return betas, alphas

        tip.cache_attention_auto, tip.beta_alpha_grid = counted_kernel, counted_grid
        try:
            yield self
        finally:
            tip.cache_attention_auto, tip.beta_alpha_grid = kernel, grid


def search(ctx: Context, x: Inputs, step: tp.Sequence[int]) -> dict:
    from summer_clip_torch.methods.tip import search_hp

    t = ctx.workload["traffic"]
    logged: tp.List[dict] = []
    with GridSpy().watching() as spy:
        beta, alpha, acc = search_hp(x.features, x.labels, x.clip_logits, x.keys, x.values,
                                     search_scale=list(t["search_scale"]),
                                     search_step=list(step), beta_chunk=t["beta_chunk"],
                                     log_fn=logged.append, cache_labels=x.key_labels,
                                     device=ctx.device)
    return {"beta": beta, "alpha": alpha, "acc": acc, "logged": logged, "betas": spy.betas,
            "alphas": spy.alphas}


def setup(ctx: Context) -> State:
    t = ctx.workload["traffic"]
    x = make_inputs(ctx)
    search(ctx, x, (t["beta_chunk"] + t["beta_chunk"] // 2, t["search_step"][1]))
    sync(ctx.device)
    return State(x)


def window(ctx: Context, st: State) -> dict:
    t = ctx.workload["traffic"]
    points = t["search_step"][0] * t["search_step"][1]
    t0 = time.perf_counter()
    while True:
        with ctx.spans.span("search"):
            st.searches.append(search(ctx, st.inputs, t["search_step"]))
        ctx.spans.count("searches")
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    elapsed = time.perf_counter() - t0
    n = len(st.searches)
    return {"seconds": elapsed, "attempted": n,
            "end_to_end": {"sweep_points_per_s": n * points / elapsed}}


def release(ctx: Context, st: State) -> dict:
    x = st.inputs
    out = {"inputs": Inputs(x.features, x.labels, x.clip_logits.cpu(), x.keys, x.values,
                            x.key_labels),
           "searches": st.searches}
    del st.inputs
    return out


def reference_grid(ctx: Context, x: Inputs, dtype: torch.dtype = torch.float32) -> np.ndarray:
    t = ctx.workload["traffic"]
    no_tf32()
    betas, alphas = ref_cache.beta_alpha_grid(t["search_scale"], t["search_step"])
    dev = ctx.device
    return ref_cache.tip_grid(torch.from_numpy(x.features).to(dev),
                              torch.from_numpy(x.labels).to(dev), x.clip_logits.to(dev),
                              torch.from_numpy(x.keys).to(dev),
                              torch.from_numpy(x.key_labels.astype(np.int64)).to(dev),
                              t["classes"], betas, alphas, dtype=dtype)


def grid_search(grid: np.ndarray, betas: np.ndarray, alphas: np.ndarray, chunk: int) -> dict:
    """What ``search_hp`` returns and logs, from a whole grid of accuracies:
    the first maximum in grid order, and each improvement of a chunk's best."""
    logged, best = [], (-1.0, 0.0, 0.0)
    for s in range(0, len(betas), chunk):
        part = grid[s:s + chunk]
        bi, ai = np.unravel_index(np.argmax(part), part.shape)
        if part[bi, ai] > best[0]:
            best = (float(part[bi, ai]), float(betas[s + bi]), float(alphas[ai]))
            logged.append({"beta": best[1], "alpha": best[2], "acc": best[0]})
    return {"beta": best[1], "alpha": best[2], "acc": best[0], "logged": logged}


def compare(ctx: Context, searches: tp.Sequence[dict], ref: np.ndarray
            ) -> tp.Tuple[tp.List[Check], int]:
    t, limits = ctx.workload["traffic"], ctx.workload["limits"]
    betas, alphas = ref_cache.beta_alpha_grid(t["search_scale"], t["search_step"])

    def index(grid: np.ndarray, value: float) -> tp.Optional[int]:
        i = int(np.argmin(np.abs(grid - value)))
        return i if abs(grid[i] - value) <= 1e-5 else None     # None: not a point of the grid

    def at(beta: float, alpha: float) -> tp.Optional[float]:
        bi, ai = index(betas, beta), index(alphas, alpha)
        return None if bi is None or ai is None else float(ref[bi, ai])

    def covered(s: dict) -> int:
        bs = {index(betas, b) for b in s["betas"]} - {None}
        als = {index(alphas, a) for a in s["alphas"]} - {None}
        return len(bs) * len(als)

    acc_gap, failed, missing = 0.0, 0, 0
    for s in searches:
        short = betas.size * alphas.size - covered(s)
        missing += short
        gaps = []
        for rec in [*s["logged"], s]:
            want = at(rec["beta"], rec["alpha"])
            gaps.append(float("inf") if want is None else abs(rec["acc"] - want))
        last = s["logged"][-1] if s["logged"] else None
        if last is None or (last["beta"], last["alpha"], last["acc"]) != (s["beta"], s["alpha"],
                                                                          s["acc"]):
            gaps.append(float("inf"))         # the returned point must be the last logged
        if max(gaps) > limits["acc_gap_pp"] or short:
            failed += 1
        acc_gap = max(acc_gap, max(gaps))
    if not searches:
        acc_gap = float("inf")
    return ([Check("acc_gap_pp", acc_gap, limits["acc_gap_pp"]),
             Check("grid_points_missing", float(missing), 0.0)], failed)


def check(ctx: Context, payload: dict) -> tp.Tuple[tp.List[Check], int]:
    ref = reference_grid(ctx, payload["inputs"])
    return compare(ctx, payload["searches"], ref)


def control(ctx: Context) -> tp.List[Check]:
    """The reference in bf16 in the program's place."""
    t = ctx.workload["traffic"]
    x = make_inputs(ctx)
    x.clip_logits = x.clip_logits.cpu()
    betas, alphas = ref_cache.beta_alpha_grid(t["search_scale"], t["search_step"])
    low = grid_search(reference_grid(ctx, x, torch.bfloat16), betas, alphas, t["beta_chunk"])
    low.update(betas=betas.tolist(), alphas=alphas.tolist())
    return compare(ctx, [low], reference_grid(ctx, x))[0]
