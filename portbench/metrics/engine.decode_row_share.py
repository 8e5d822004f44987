"""The share of the slab rows a fleet decode computes that step, in %:
100 x ``engine.decode_rows_stepped`` (the stepped masks' sums, at the
reconcile) / ``engine.decode_rows_computed`` (the rows of the shards
each dispatch ran x max_batch x micro-steps, at dispatch) over the traced
slice, from ``repro_torch.telemetry.session()``; nothing where the
program has no counters or the slice no tick or no decode."""


def read(ctx):
    if ctx.trace is None:
        return None
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    s = telemetry.session()
    rows = s.counters.get("engine.decode_rows_computed", 0)
    if not rows or not s.spans.get("plane.step"):
        return None
    return 100.0 * s.counters.get("engine.decode_rows_stepped", 0) / rows
