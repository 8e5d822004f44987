"""flash_decode's share of its roofline over the traced slice
(``reduce.roofline``), in %."""
from portbench import reduce


def read(ctx):
    return reduce.roofline(ctx, "flash_decode")
