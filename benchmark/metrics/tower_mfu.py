"""The image tower's share of the card's bf16 peak, in percent: the products
of one image counted from the published shapes (``roofline.vit_image_flops``:
patch embedding, every projection, QK^T and PV, the final projection) times
the traced window's images a second, over 989 TFLOP/s."""

from benchmark import roofline


def read(r):
    rate = r.end_to_end.get("images_per_s")
    if not rate:
        return None
    c = r.config
    flops = roofline.vit_image_flops(c["image_resolution"], c["vision_patch_size"],
                                     c["vision_width"], c["vision_layers"], c["embed_dim"],
                                     c["mlp_ratio"])
    return 100.0 * flops * rate / roofline.PEAK_BF16
