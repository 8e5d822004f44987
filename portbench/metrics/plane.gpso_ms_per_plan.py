"""Host ms a GPSO plan: the seconds of the program's ``plane.gpso_plan``
spans (``scaler.plan``, every ``scale_interval`` ticks) over their count
in the traced slice, from ``repro_torch.telemetry.session()``; nothing
where the program has no spans or the slice no tick or no plan."""


def read(ctx):
    if ctx.trace is None:
        return None
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    spans = telemetry.session().spans
    sec, n = spans.get("plane.gpso_plan", (0.0, 0))
    return sec / n * 1e3 if n and spans.get("plane.step") else None
