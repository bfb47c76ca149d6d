"""% of the card's dense bf16 peak in the model's forward and backward
operations at the unprofiled window's train rate."""
from benchmark import readers


def read(ctx):
    return readers.mfu(ctx, "train_images_per_s", train=True)
