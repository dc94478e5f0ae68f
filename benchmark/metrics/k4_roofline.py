"""K4's share of its roofline, in percent: the least time of every K4 launch
of the window (``roofline.attention`` at the image tower's shape, a batch
and a block each) over the device time of the kernel that computes it.

Kernel map: ``attention_bf16_kernel`` (``csrc/attention_kernels.cu``). In
this cell it runs only as K4 (the ViT-L/14 image tower takes the module
route); where its launch count is not a batch's blocks times the batches
encoded, the map does not hold and nothing is read."""

from benchmark import roofline

KERNELS = ("attention_bf16_kernel",)


def read(r):
    c, t = r.config, r.workload["traffic"]
    launches = sum(r.kernels.get(k, (0, 0.0))[0] for k in KERNELS)
    seconds = sum(r.kernels.get(k, (0, 0.0))[1] for k in KERNELS)
    batches = r.spans.counters.get("batches", 0)
    if not launches or launches != batches * c["vision_layers"]:
        return None
    grid = c["image_resolution"] // c["vision_patch_size"]
    work = roofline.attention(t["batch"], grid * grid + 1, c["vision_width"], c["vision_heads"])
    return 100.0 * launches * roofline.least_seconds(work, r.card) / seconds
