"""The whole serve step's share of the card's dense bf16 peak, in %: the
reference model's FLOPs an image (its forward's) times the traced
window's images/s over ``yardstick.PEAK_BF16_FLOP_PER_S``."""

from benchmark import yardstick


def read(ctx):
    return 100.0 * ctx["flops_per_image"] * ctx["images_per_s"] / (
        yardstick.PEAK_BF16_FLOP_PER_S)
