"""The whole search's share of the card's peak, in percent: the least time
its work needs (``roofline.tip_search`` or ``roofline.clip_search_pass``:
affinity products, exponentials, value products, blends and their bytes)
times the searches or passes of the window, over the window's seconds."""

from benchmark import roofline


def read(r):
    t, c = r.workload["traffic"], r.config
    if r.workload["driver"] == "tip_search":
        n = r.spans.counters.get("searches", 0)
        work = roofline.tip_search(t["classes"] * t["test_per_class"], t["classes"] * t["shots"],
                                   c["embed_dim"], t["classes"], t["search_step"][0],
                                   t["search_step"][1])
    elif r.workload["driver"] == "clip_search":
        n = r.spans.counters.get("passes", 0)
        classes = len(t["classnames"])
        work = roofline.clip_search_pass(classes * t["test_per_class"],
                                         classes * t["train_per_class"], c["embed_dim"], classes,
                                         len(t["betas"]), len(t["alphas"]), len(t["value_scales"]))
    else:
        return None
    if not n or r.window_s <= 0:
        return None
    return 100.0 * n * roofline.least_seconds(work, r.card) / r.window_s
