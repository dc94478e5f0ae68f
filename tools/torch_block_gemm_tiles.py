"""K5's and K6's products on a CUDA card, tile by tile.

Times ``block_gemm`` (``csrc/block_kernels.cu``) for each of the four
products of a residual block (in_proj + bias, out_proj + bias + residual,
c_fc + bias + QuickGELU, c_proj + bias + residual) at the towers' shapes
(ViT-B/16 image B=32, text B=256, the ViT-L/14 text tower at B=256 and at a
CoOp forward's B=1000) with every block tile (256, 192, 128 columns), beside
``torch.matmul`` on the same product (cuBLAS, a yardstick used nowhere in
the port). Marks the tile ``ops.block_kernels.gemm_tile`` picks (``*``), and
checks that every tile gives the same bits.

With ``--probe`` it also builds three probe copies of the source and times
them on the same products at the 256-column tile: "products only" (after the
first ring the loader arrives on each stage without loading, so the
consumers multiply whatever the ring holds), the same with no epilogue (the
consumers stop after their last product), and "loads only" (the consumers
wait for each stage and release it without multiplying). Each against the
whole kernel says whether the loads, the products or the epilogue bind it.

Run: ``python tools/torch_block_gemm_tiles.py [--probe]`` (on the card, about
a minute; the probe builds add half a minute). Inputs are random from a seed;
nothing is read from disk.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from summer_clip_torch.ops import _lib  # noqa: E402
from summer_clip_torch.ops import block_kernels as bk  # noqa: E402

SHAPES = {"vit_b16_image": (32 * 197, 768), "vit_b16_text": (256 * 77, 512),
          "vit_l14_text": (256 * 77, 768), "coop_l14_text": (1000 * 77, 768)}


# (anchor in csrc/block_kernels.cu, replacement) for each probe copy
PROBES = {
    "products only": [(
        "        mbar_expect(bar, T::kStageBytes);\n",
        "        if (kb >= S) {\n          mbar_arrive(bar);\n          continue;\n        }\n"
        "        mbar_expect(bar, T::kStageBytes);\n")],
    "products only, no epilogue": [
        ("        mbar_expect(bar, T::kStageBytes);\n",
         "        if (kb >= S) {\n          mbar_arrive(bar);\n          continue;\n        }\n"
         "        mbar_expect(bar, T::kStageBytes);\n"),
        # every accumulator stays live (ptxas drops products whose results go
        # unused), summed once instead of rounded, stored and written out
        ("  wgmma_wait_n<0>();\n  keep_n(acc);\n\n",
         "  wgmma_wait_n<0>();\n  keep_n(acc);\n  float sum = 0.f;\n"
         "  for (int i = 0; i < BN / 2; ++i) sum += acc[i];\n"
         "  if (sum == 1234.5f) __trap();\n  return;\n")],
    "loads only": [(
        "    wgmma_fence();\n#pragma unroll\n    for (int kk = 0; kk < kDepth / 16; ++kk)\n"
        "      wgmma_ss(acc, sw128_desc(a_t + 32 * kk), sw128_desc(b_t + 32 * kk), (kb | kk) != 0);\n"
        "    wgmma_commit();\n    wgmma_wait_n<1>();",
        "    if (kb == 0)\n      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;")],
}


def build_probes() -> dict:
    """One library a probe, built from an edited copy of the tree's source."""
    src = (_lib.CSRC_DIR / "block_kernels.cu").read_text()
    out_dir = Path(tempfile.mkdtemp(prefix="block_gemm_probe_"))
    for header in _lib.CSRC_DIR.glob("*.cuh"):
        shutil.copy(header, out_dir)
    procs = {}
    for name, edits in PROBES.items():
        text = src
        for anchor, new in edits:
            if text.count(anchor) != 1:
                raise RuntimeError(f"probe {name!r}: its anchor is not in block_kernels.cu once")
            text = text.replace(anchor, new)
        cu = out_dir / (re.sub(r"\W+", "_", name) + ".cu")   # nvcc splits names at commas
        cu.write_text(text)
        procs[name] = (subprocess.Popen([_lib._nvcc(), *_lib.NVCC_FLAGS, "-o",
                                         str(cu.with_suffix(".so")), str(cu)]), cu)
    libs = {}
    for name, (proc, cu) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the probe {name!r}")
        lib = ctypes.CDLL(str(cu.with_suffix(".so")))
        for fn, argtypes in bk._SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes, f.restype = list(argtypes), ctypes.c_int
        libs[name] = lib
    return libs


def gemm(lib, a, w, bias, epilogue: str, res, tile: int) -> torch.Tensor:
    """One ``block_gemm`` launch at a given tile (columns), on ``lib``'s build."""
    (m, k), n = a.shape, w.shape[0]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    _lib.check(lib.block_gemm_bf16(a.data_ptr(), w.data_ptr(), bias.data_ptr(),
                                   res.data_ptr() if res is not None else None, out.data_ptr(),
                                   m, n, k, tile, bk._EPILOGUES[epilogue], _lib.torch_stream()),
               "block_gemm")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--probe", action="store_true",
                        help="also time the products-only and loads-only probe copies")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_block_gemm_tiles: needs a CUDA card", file=sys.stderr)
        return 2
    print(f"card: {chip_smoke.card_line()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = bk._lib_block()
    probes = build_probes() if args.probe else {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator().manual_seed(0)
    for shape, (m, d) in SHAPES.items():
        x = chip_smoke._randn((m, d), gen)
        h = chip_smoke._randn((m, 4 * d), gen)
        products = {   # name: (a, w, bias, epilogue, residual)
            "in_proj": (x, chip_smoke._randn((3 * d, d), gen, d ** -0.5),
                        chip_smoke._randn((3 * d,), gen, 0.02), "bias", None),
            "out_proj": (x, chip_smoke._randn((d, d), gen, d ** -0.5),
                         chip_smoke._randn((d,), gen, 0.02), "residual", x),
            "c_fc": (x, chip_smoke._randn((4 * d, d), gen, d ** -0.5),
                     chip_smoke._randn((4 * d,), gen, 0.02), "gelu", None),
            "c_proj": (h, chip_smoke._randn((d, 4 * d), gen, (4 * d) ** -0.5),
                       chip_smoke._randn((d,), gen, 0.02), "residual", x)}
        for name, (a, w, b, epi, res) in products.items():
            n, k = w.shape
            flops = 2 * m * n * k
            picked = bk.gemm_tile(m, n, k, sms)
            mm_ms = chip_smoke.cuda_time_ms(lambda: torch.matmul(a, w.t()), 20)
            line = [f"{shape:14s} {name:8s} ({m} x {k}) . ({k} x {n}) {epi:8s}: "
                    f"cuBLAS {mm_ms:.4f} ms ({flops / mm_ms / 1e9:.0f} TFLOP/s)"]
            first = None
            for bn in bk.GEMM_TILES:
                def run(tile=bn):
                    return gemm(lib, a, w, b, epi, res, tile)
                got = run()
                torch.cuda.synchronize()
                if first is None:
                    first = got
                elif not torch.equal(got, first):
                    raise AssertionError(f"{shape} {name}: tile {bn} differs from {bk.GEMM_TILES[0]}")
                ms = chip_smoke.cuda_time_ms(run, 20)
                mark = "*" if bn == picked else ""
                line.append(f"{bn}{mark} {ms:.4f} ms ({flops / ms / 1e9:.0f} TFLOP/s)")
            for probe, plib in probes.items():
                ms = chip_smoke.cuda_time_ms(
                    lambda p=plib: gemm(p, a, w, b, epi, res, 256), 20)
                intake = -(-m // bk.GEMM_ROWS) * -(-n // 256) * -(-k // bk.GEMM_DEPTH) * (
                    bk.GEMM_ROWS + 256) * bk.GEMM_DEPTH * 2
                line.append(f"256 {probe} {ms:.4f} ms ({flops / ms / 1e9:.0f} TFLOP/s, "
                            f"{intake / ms / 1e9:.2f} TB/s of L2 intake)")
            print(" | ".join(line), flush=True)
    print(f"card: {chip_smoke.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
