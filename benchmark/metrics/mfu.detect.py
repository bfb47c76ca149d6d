"""% of the card's dense bf16 peak in the model's forward operations at the
unprofiled window's detect rate."""
from benchmark import readers


def read(ctx):
    return readers.mfu(ctx, "detect_images_per_s", train=False)
