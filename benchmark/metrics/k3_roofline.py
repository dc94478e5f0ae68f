"""K3's share of its roofline, in percent: the least time of every chunk of
every search in the window (``roofline.label_cache`` at the chunk's betas)
over the device time of the kernels that compute it.

Kernel map (``csrc/cache_kernels.cu``): ``grouped_kernel`` (the class-grouped
template K2 and K3 share; the cell's class-grouped cache takes K3) and
``grouped_fix_kernel`` (its fix-up of the classes a work item cuts). Where
``grouped_kernel`` does not launch once a chunk, nothing is read."""

from benchmark import roofline

KERNELS = ("grouped_kernel", "grouped_fix_kernel")


def read(r):
    t, c = r.workload["traffic"], r.config
    searches = r.spans.counters.get("searches", 0)
    betas, chunk = t["search_step"][0], t["beta_chunk"]
    sizes = [min(chunk, betas - s) for s in range(0, betas, chunk)]
    if not searches or r.kernels.get("grouped_kernel", (0, 0.0))[0] != searches * len(sizes):
        return None
    nt, nc = t["classes"] * t["test_per_class"], t["classes"] * t["shots"]
    least = sum(roofline.least_seconds(
        roofline.label_cache(nt, nc, c["embed_dim"], t["classes"], b), r.card) for b in sizes)
    seconds = sum(r.kernels.get(k, (0, 0.0))[1] for k in KERNELS)
    return 100.0 * searches * least / seconds
