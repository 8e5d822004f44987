"""The whole step's share of the bf16 peak over the traced slice
(``reduce.mfu``), in %."""
from portbench import reduce


def read(ctx):
    return reduce.mfu(ctx)
