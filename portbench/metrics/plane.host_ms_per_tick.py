"""Host ms a tick of the control plane (forecast, balance, learn, scale):
the change of ``plane.host_s`` summed over its keys, over the window's
ticks."""
from portbench import reduce


def read(ctx):
    return reduce.per_tick(ctx, "plane_host_s", 1e3)
