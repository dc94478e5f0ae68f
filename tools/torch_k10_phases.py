"""Where a launch of K10 (``ops/gemv.fused_qmlp``) spends its time, phase by phase.

Runs on a CUDA card: ``python tools/torch_k10_phases.py`` (under a minute on an
H100). It builds a copy of ``csrc/gemv_kernels.cu`` with ``-DK10_PROBE`` (every
CTA's globaltimer at the end of each phase of its work), launches K10 at
gpt2-large width (D = 1280, H = 5120) with R = 1, 3 and 8 rows, each launch on
its own copy of the weights so that they come from device memory, and prints,
for each phase, the median and the largest time over the CTAs from the grid's
first start to the phase's end, medians over the launches; then how many CTAs
added column groups of the output and the most groups one CTA added.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PHASES = ("start", "w1 asked, x staged, w2 asked", "first product", "sums pushed",
          "sums exchanged", "hidden", "second product", "partials written", "tickets drawn",
          "groups added", "(first product's warp sums)", "(second product's warp sums)",
          "(partials landed)", "(partials added)", "(groups stored)")
SLOTS = len(PHASES) + 1      # the phases, then the groups a CTA added


def probe_build():
    """gemv_kernels.cu built with -DK10_PROBE, in place of the tree's build."""
    from summer_clip_torch.ops import _lib, gemv

    out = Path(tempfile.mkdtemp(prefix="k10_probe_")) / "libgemv_probe.so"
    proc = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-DK10_PROBE", "-o", str(out),
                           str(_lib.CSRC_DIR / "gemv_kernels.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in {**gemv._SIGNATURES, "fused_qmlp_stamps": [ctypes.c_void_p, ctypes.c_int]}.items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = list(argtypes), ctypes.c_int
    _lib._LIBS["gemv_kernels"] = lib
    return lib


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("this tool runs only on a CUDA card", file=sys.stderr)
        return 2
    from summer_clip_torch.ops import _lib, gemv

    lib = probe_build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    d, h, copies, launches = 1280, 5120, 10, 10
    gen = torch.Generator(device="cuda").manual_seed(0)
    pairs = [(torch.randint(-127, 128, (d, h), dtype=torch.int8, device="cuda", generator=gen),
              torch.randint(-127, 128, (h, d), dtype=torch.int8, device="cuda", generator=gen))
             for _ in range(copies)]
    s1, s2 = torch.full((h,), 1e-3, device="cuda"), torch.full((d,), 1e-3, device="cuda")
    b1, b2 = torch.zeros(h, device="cuda"), torch.zeros(d, device="cuda")
    plan = gemv.k10_plan(d, h)
    print(f"plan {plan}: {plan.ctas} CTAs")
    host = np.zeros((1024, SLOTS), np.int64)
    for rows in (1, 3, 8):
        x = torch.randn((rows, d), device="cuda", generator=gen)
        ends, maxes, adders, most = [], [], [], []
        for i in range(launches + 1):
            w1, w2 = pairs[i % copies]
            gemv.fused_qmlp(x, w1, s1, b1, w2, s2, b2)
            torch.cuda.synchronize()
            _lib.check(lib.fused_qmlp_stamps(host.ctypes.data, host.size), "fused_qmlp_stamps")
            if i == 0:
                continue        # the first launch loads the module
            st = host[:plan.ctas]
            rel = (st[:, :len(PHASES)] - st[:, 0].min()) / 1e3
            for name in ("(partials landed)", "(partials added)", "(groups stored)"):
                rel[st[:, -1] == 0, PHASES.index(name)] = np.nan   # CTAs that added none
            ends.append(np.nanmedian(rel, axis=0))
            maxes.append(np.nanmax(rel, axis=0))
            adders.append(int((st[:, -1] > 0).sum()))
            most.append(int(st[:, -1].max()))
        med, top = np.median(ends, axis=0), np.median(maxes, axis=0)
        print(f"R={rows}: us from the grid's first start to each phase's end, median CTA / last "
              f"CTA (medians over {launches} launches on cold weights)")
        for name, m, t in zip(PHASES, med, top):
            print(f"  {name:34s} {m:8.3f} {t:8.3f}")
        print(f"  CTAs that added column groups: {int(np.median(adders))} of {plan.ctas}; the most "
              f"groups one CTA added: {int(np.median(most))} of {d // 16}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
