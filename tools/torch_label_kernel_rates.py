"""What binds the class-grouped label kernels (K2, K3, K13) on a CUDA card.

Prints, on one card in one process:

- the weight-rate probe: bf16 weights a clock an SM that a loop of nothing
  but weights reaches (``weight_rate_probe_bf16`` in ``csrc/cache_kernels.cu``:
  the walk's arithmetic with no tiles, no class boundaries and no stores);
- K3 at the Tip shape (Nt=8192, Nc=16000, D=512, 16 betas) against the rows a
  class, from 1 (16000 classes: a class closes at every row, 8.4 GB of output)
  to 1600 (10 classes: almost no boundary), each beside the weights a clock an
  SM it reached.

Run: ``python tools/torch_label_kernel_rates.py`` (on the card, under a
minute). The rows are random unit rows from a seed; nothing is read from disk.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from summer_clip_torch.ops import cache_kernels as ck  # noqa: E402

NT, NC, D, NB = 8192, 16000, 512, 16
ROWS_A_CLASS = (1, 4, 8, 16, 64, 160, 1600)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_label_kernel_rates: needs a CUDA card", file=sys.stderr)
        return 2
    print(f"card: {chip_smoke.card_line()}", flush=True)
    chip_smoke.read_card_clock()
    clock = chip_smoke.CARD["sms"] * chip_smoke.CARD["sm_clock_hz"]
    chip_smoke.check_weight_rate()
    rng = np.random.default_rng(0)
    a = rng.standard_normal((NT + NC, D)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    f, keys = torch.from_numpy(a[:NT]).cuda(), torch.from_numpy(a[NT:]).cuda()
    betas = torch.linspace(0.1, 11.5, NB, device="cuda")
    for per_class in ROWS_A_CLASS:
        c = NC // per_class
        labels = np.repeat(np.arange(c, dtype=np.int32), per_class)
        ms = chip_smoke.cuda_time_ms(lambda: ck.cache_attention_onehot(f, keys, labels, betas, c),
                                     3, 1)
        rate = NB * NT * NC / (ms * 1e-3) / clock
        print(f"K3 Nt={NT} Nc={NC} D={D} betas={NB}, {per_class:4d} rows a class (C={c:5d}, "
              f"output {4 * NB * NT * c / 1e9:.2f} GB): {ms:.4f} ms, {rate:.2f} weights a clock "
              f"an SM", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
