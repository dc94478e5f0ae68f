"""K1's share of its roofline, in percent: the least time of every launch of
the window (``roofline.dense_cache``: the whole cache, a value strategy's
soft values, up to 8 betas a launch) over the device time of the kernel.

Kernel map: ``cache_dense_kernel`` (``csrc/cache_kernels.cu``). Where it
does not launch once a value strategy and beta launch a pass, nothing is
read."""

from benchmark import roofline

KERNELS = ("cache_dense_kernel",)
BETAS_A_LAUNCH = 8


def read(r):
    t, c = r.workload["traffic"], r.config
    passes = r.spans.counters.get("passes", 0)
    betas = len(t["betas"])
    sizes = [min(BETAS_A_LAUNCH, betas - s) for s in range(0, betas, BETAS_A_LAUNCH)]
    per_pass = len(t["value_scales"]) * len(sizes)
    launches, seconds = r.kernels.get(KERNELS[0], (0, 0.0))
    if not passes or launches != passes * per_pass:
        return None
    classes = len(t["classnames"])
    nt, nc = classes * t["test_per_class"], classes * t["train_per_class"]
    least = len(t["value_scales"]) * sum(roofline.least_seconds(
        roofline.dense_cache(nt, nc, c["embed_dim"], classes, b), r.card) for b in sizes)
    return 100.0 * passes * least / seconds
