"""Live replicas summed over the nodes, the mean over the window's ticks
(the GPSO autoscaler's decisions)."""


def read(ctx):
    reps = ctx.window["replicas"]
    return sum(reps) / len(reps) if reps else None
