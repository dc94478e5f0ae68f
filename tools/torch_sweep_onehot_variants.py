"""Sweep of the skinny one-hot cache kernel's variants (K13) on a CUDA card.

Counterpart of ``tools/sweep_onehot_variants.py`` for the PyTorch port. It
times K13 (``summer_clip_torch.ops.cache_kernels.onehot_variant``) in the JAX
tool's arms, each precision of the class-sum scatter at two cache blockings,
against the dense kernel K1 (``cache_attention`` over int8 one-hot values) on
the same inputs, and prints each arm's time and the relative distance of its
output's sum from the dense kernel's:

  highest (+cast) : partials added in f32 as they are
  split3          : partials added as (hi + mid) + lo of their bf16 parts (exact)
  default         : partials rounded to bf16 before they are added

at ``block_n`` 1024 and 2048, over the two geometries of the JAX tool:
Nt=50176 test rows, D=1024, C=1000 classes, 8 betas, first 16 cache rows a
class (Nc=16000), then the full sorted cache of 1,281,024 rows (2.6 GB of
bf16). The rows are random bf16 unit rows drawn on the device from a seed;
nothing is read from disk.

Run: ``python tools/torch_sweep_onehot_variants.py`` (both geometries, a few
minutes; K1 alone takes tens of seconds a call at the full cache, so it is
timed once there) or ``--small`` for the first geometry only. ``bench`` is
importable (``chip_smoke.py`` drives the first geometry through it).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from summer_clip_torch.ops import cache_kernels as ck  # noqa: E402

ARMS = (("highest", True), ("split3", False), ("default", False))
BLOCK_NS = (1024, 2048)
BETAS = np.linspace(0.1, 11.5, 8).astype(np.float32)


def unit_rows(n: int, d: int, gen: torch.Generator, device) -> torch.Tensor:
    """``n`` random bf16 rows of unit norm, drawn on ``device``."""
    x = torch.randn(n, d, generator=gen, device=device, dtype=torch.bfloat16).float()
    return (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)


def _timed(fn, device) -> tuple:
    """(output, seconds) of one call, the device drained before and after."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def bench(nt: int, nc: int, d: int, c: int, rows_per_class, *, device="cuda",
          block_ns=BLOCK_NS, seed: int = 0, quiet: bool = False) -> dict:
    """Time K13's arms against K1 at one geometry; return the rows printed.

    ``rows_per_class`` set: a class-grouped cache of that many rows a class
    (``nc`` is ignored); ``None``: ``nc`` rows with sorted random labels, as
    the JAX tool. Every call runs once to warm up and once timed, except K1
    over a cache above 100k rows, which runs once."""
    if rows_per_class is not None:
        nc = rows_per_class * c
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    f = unit_rows(nt, d, gen, device)
    cf = unit_rows(nc, d, gen, device)
    labels = (np.sort(rng.randint(0, c, nc)) if rows_per_class is None
              else np.repeat(np.arange(c), rows_per_class)[:nc]).astype(np.int32)
    betas = torch.from_numpy(BETAS).to(device)

    values = torch.zeros(nc, c, dtype=torch.int8, device=device)
    values[torch.arange(nc, device=device), torch.from_numpy(labels).long().to(device)] = 1
    dense_call = lambda: ck.cache_attention(f, cf, values, betas)   # noqa: E731
    if nc <= 100_000:
        dense_call()
    out, t_dense = _timed(dense_call, device)
    s_dense = float(out.double().sum())
    del out, values

    rows = [{"arm": "dense (K1, int8 one-hots)", "seconds": t_dense, "checksum_rel": 0.0}]
    for block_n in block_ns:
        for mode, cast_w in ARMS:
            call = lambda m=mode, w=cast_w, n=block_n: ck.onehot_variant(  # noqa: E731
                f, cf, labels, betas, c, block_n=n, expand_mode=m, cast_w=w)
            call()
            out, dt = _timed(call, device)
            s = float(out.double().sum())
            del out
            rows.append({"arm": f"{mode}{'(+cast)' if cast_w else ''} block_n={block_n}",
                         "mode": mode, "cast_w": cast_w, "block_n": block_n, "seconds": dt,
                         "checksum_rel": abs(s - s_dense) / max(abs(s_dense), 1e-9)})
    if not quiet:
        print(f"[Nt={nt} Nc={nc} D={d} C={c} rows/class={rows_per_class} betas={len(BETAS)}]")
        for r in rows:
            print(f"  {r['arm']:34s} {r['seconds']:9.4f}s  vs_dense={t_dense / r['seconds']:6.2f}x"
                  f"  checksum_rel={r['checksum_rel']:.3e}", flush=True)
    return {"nt": nt, "nc": nc, "d": d, "c": c, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true", help="only the 16-rows-a-class geometry")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_sweep_onehot_variants: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    bench(50176, 16384, 1024, 1000, rows_per_class=16)        # top16-per-class
    if not args.small:
        bench(50176, 1281024, 1024, 1000, rows_per_class=None)  # full sorted cache
    return 0


if __name__ == "__main__":
    sys.exit(main())
