"""The share of the traced slice in which no kernel, copy or set ran on
the device, in %."""
from portbench import reduce


def read(ctx):
    return reduce.idle_share(ctx)
