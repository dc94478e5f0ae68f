"""The grid points the program evaluated over those the rate credits, in
percent: its ``tip.points`` counter (the size of every chunk's accuracy array,
``methods/tip.search_hp``) over the window's searches times the (beta, alpha)
grid, or its ``search.points`` counter (value x beta x alpha accuracies,
``apps/image_attention``) over the window's passes times a pass's points.
100 where every credited point was blended and ranked; below it where the
program left points out, which the harness's own count cannot see."""

from benchmark import program_spans


def read(r):
    rec = program_spans.recorded(r)
    if rec is None:
        return None
    t = r.workload["traffic"]
    if r.workload["driver"] == "tip_search":
        counted = rec.counters.get("tip.points", 0)
        credited = r.spans.counters.get("searches", 0) * t["search_step"][0] * t["search_step"][1]
    elif r.workload["driver"] == "clip_search":
        counted = rec.counters.get("search.points", 0)
        credited = r.spans.counters.get("passes", 0) * (
            len(t["selections"]) * len(t["value_scales"]) * len(t["betas"]) * len(t["alphas"]))
    else:
        return None
    return 100.0 * counted / credited if counted and credited else None
