"""Decode-graph captures and recaptures (after a slab growth) in the
window, from the frontend's ``graph_stats()``."""


def read(ctx):
    return ctx.window["captures"] if ctx.window["ticks"] else None
