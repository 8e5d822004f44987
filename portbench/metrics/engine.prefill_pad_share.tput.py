"""The share of the fleet prefills' token slots (K x sb a shard's
prefill: rows padded to a power of two, prompts to their bucket) that
hold no prompt token, in %: 100 x (1 - ``engine.prefill_tokens`` /
``engine.prefill_slots``) over the traced slice, from
``repro_torch.telemetry.session()``; nothing where the program has no
counters or the slice no tick or no prefill."""


def read(ctx):
    if ctx.trace is None:
        return None
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    s = telemetry.session()
    slots = s.counters.get("engine.prefill_slots", 0)
    if not slots or not s.spans.get("plane.step"):
        return None
    return 100.0 * (1.0 - s.counters["engine.prefill_tokens"] / slots)
