"""% of the traced detect stretch in which the device ran nothing."""
from benchmark import readers


def read(ctx):
    return readers.idle_share(ctx)
