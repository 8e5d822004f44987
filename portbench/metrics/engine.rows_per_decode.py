"""Rows a fleet decode dispatch: the decode tokens emitted in the window
(every token but a request's first) over the fleet decode dispatches
issued in it."""


def read(ctx):
    w = ctx.window
    return w["decode_tokens"] / w["decode_dispatches"] \
        if w["decode_dispatches"] else None
