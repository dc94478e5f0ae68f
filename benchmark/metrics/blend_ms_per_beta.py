"""Device milliseconds a beta outside the cache kernels in the Tip search:
every kernel's device time in the window but ``grouped_kernel`` and
``grouped_fix_kernel`` (K3), over the betas the window's searches swept. It
is the alpha blend, the argmax and the accuracies of ``methods/tip``."""

CACHE_KERNELS = ("grouped_kernel", "grouped_fix_kernel")


def read(r):
    betas = r.spans.counters.get("searches", 0) * r.workload["traffic"]["search_step"][0]
    if not betas:
        return None
    seconds = sum(s for name, (_, s) in r.kernels.items() if name not in CACHE_KERNELS)
    return 1e3 * seconds / betas
