"""Ms a tick the frontend's host waited on device results: the change of
``fe.sync_wait_s()`` over the window's ticks."""
from portbench import reduce


def read(ctx):
    return reduce.per_tick(ctx, "sync_wait_s", 1e3)
