"""K5's share of its roofline, in percent: the least time of the attention
half of every image-tower block of the window (``roofline.fused_attn_half`` at
the tower's shape: K5's LN, in_proj, attention and out_proj) over the device
time of the program's ``block.attn`` spans inside ``tower.image`` (CUDA events
on the tower's stream, ``models/clip/modeling.ResidualAttentionBlock``).

In the ViT-B/16 image tower every block's attention half is K5. Where the
spans are not one a block of every batch encoded (``extract.batches`` times
the configuration's layers), nothing is read."""

from benchmark import program_spans, roofline


def read(r):
    rec = program_spans.recorded(r)
    if rec is None:
        return None
    c, t = r.config, r.workload["traffic"]
    blocks = rec.counters.get("extract.batches", 0) * c["vision_layers"]
    spans = program_spans.device_seconds_under(rec, "block.attn", "tower.image")
    if not blocks or not spans or len(spans) != blocks:
        return None
    grid = c["image_resolution"] // c["vision_patch_size"]
    work = roofline.fused_attn_half(t["batch"], grid * grid + 1, c["vision_width"],
                                    c["vision_heads"])
    return 100.0 * blocks * roofline.least_seconds(work, r.card) / sum(spans)
