"""The K5 + K6 chains' share of their roofline, in percent: the least time
of every residual block of the window (``roofline.block_chain``: K5's LN,
in_proj, attention and out_proj and K6's LN and two products, at the image
tower's shape) over the device time of the chains' launches.

Kernel map (``csrc/block_kernels.cu``): ``ln_rows_kernel`` and
``block_gemm_kernel`` (launched by both K5 and K6, so their work is counted
together) and ``attention_bf16_kernel`` (K4's device code inside K5). In the
ViT-B/16 image tower every block runs the chains; where ``ln_rows_kernel``
does not launch twice a block, the map does not hold and nothing is read."""

from benchmark import roofline

KERNELS = ("ln_rows_kernel", "block_gemm_kernel", "attention_bf16_kernel")


def read(r):
    c, t = r.config, r.workload["traffic"]
    blocks = r.spans.counters.get("batches", 0) * c["vision_layers"]
    if not blocks or r.kernels.get("ln_rows_kernel", (0, 0.0))[0] != 2 * blocks:
        return None
    seconds = sum(r.kernels.get(k, (0, 0.0))[1] for k in KERNELS)
    grid = c["image_resolution"] // c["vision_patch_size"]
    work = roofline.block_chain(t["batch"], grid * grid + 1, c["vision_width"], c["vision_heads"],
                                c["mlp_ratio"] * c["vision_width"])
    return 100.0 * blocks * roofline.least_seconds(work, r.card) / seconds
