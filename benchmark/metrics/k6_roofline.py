"""K6's share of its roofline, in percent: the least time of the MLP half of
every image-tower block of the window (``roofline.fused_mlp_half`` at the
tower's shape: K6's LN and two products) over the device time of the
program's ``block.mlp`` spans inside ``tower.image`` (CUDA events on the
tower's stream, ``models/clip/modeling.ResidualAttentionBlock``).

In the ViT-B/16 image tower every block's MLP half is K6. Where the spans are
not one a block of every batch encoded (``extract.batches`` times the
configuration's layers), nothing is read."""

from benchmark import program_spans, roofline


def read(r):
    rec = program_spans.recorded(r)
    if rec is None:
        return None
    c, t = r.config, r.workload["traffic"]
    blocks = rec.counters.get("extract.batches", 0) * c["vision_layers"]
    spans = program_spans.device_seconds_under(rec, "block.mlp", "tower.image")
    if not blocks or not spans or len(spans) != blocks:
        return None
    grid = c["image_resolution"] // c["vision_patch_size"]
    work = roofline.fused_mlp_half(t["batch"], grid * grid + 1, c["vision_width"],
                                   c["mlp_ratio"] * c["vision_width"])
    return 100.0 * blocks * roofline.least_seconds(work, r.card) / sum(spans)
