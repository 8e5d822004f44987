"""The share of the held experts' computed rows that serve no routed
(token, expert) pair, in %: 100 x (1 - ``moe.pairs`` / ``moe.slots``)
over the traced slice, from ``repro_torch.telemetry.session()``. A
prefill computes its pairs alone; a decode step computes every held
expert over every row, zero-gated where the row did not pick it. Nothing
where the program has no such counters or the slice no expert layer."""


def read(ctx):
    if ctx.trace is None:
        return None
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    s = telemetry.session()
    slots = s.counters.get("moe.slots", 0)
    if not slots:
        return None
    return 100.0 * (1.0 - s.counters.get("moe.pairs", 0) / slots)
