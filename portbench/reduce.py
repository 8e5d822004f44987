"""The reduction from a run's counters, work records and trace to the
per-layer metrics; each reader in ``metrics/`` is one call into here.
Every function returns None where the run gives it nothing to read (no
trace, no launch of the kernel, no tick), never 0 for a share."""
from __future__ import annotations

from portbench import peaks


def per_tick(ctx, key: str, scale: float = 1.0):
    w = ctx.window
    if not w["ticks"]:
        return None
    return w[key] / w["ticks"] * scale


def _launches(ctx, kernel: str) -> list:
    """[(per-launch lengths)] of ``kernel`` in the traced slice: one
    launch a layer of each dispatch that runs it."""
    t = ctx.trace
    fam = ctx.cfg["family"]
    kind = {"flash_decode": "decode", "flash_attention": "prefill",
            "ssd_scan": "prefill"}[kernel]
    runs = {"flash_decode": fam != "ssm", "flash_attention": fam != "ssm",
            "ssd_scan": fam == "ssm"}[kernel]
    if not runs:
        return []
    L = ctx.cfg["num_layers"]
    return [r[2] for r in t["records"] if r[0] == kind and r[2]] * L


def roofline(ctx, kernel: str):
    """Percent of the least time the card could take for the slice's
    launches of ``kernel`` (``counts/<kernel>.py``, ``peaks``) over their
    device time from the profiler."""
    t = ctx.trace
    if t is None or not t["kernel_s"].get(kernel):
        return None
    launches = _launches(ctx, kernel)
    if not launches:
        return None
    work = ctx.counts(kernel).work
    bound = sum(peaks.bound_s(*work(x, ctx.cfg),
                              peaks.KERNEL_PEAK_FLOPS[kernel])
                for x in launches)
    return 100.0 * bound / t["kernel_s"][kernel]


def mfu(ctx):
    """Percent of the bf16 peak: the model FLOPs of every prefill and
    decode token served in the traced slice (``counts/model_<family>``)
    over the slice's seconds."""
    t = ctx.trace
    if t is None or not t["records"]:
        return None
    flops = ctx.counts("model_" + ctx.cfg["family"]).flops
    total = 0.0
    for kind, _, xs in t["records"]:
        if not xs:
            continue
        if kind == "prefill":
            total += flops(ctx.cfg, sum(xs), sum(n * (n + 1) / 2 for n in xs),
                           len(xs))
        else:
            total += flops(ctx.cfg, len(xs), sum(xs), len(xs))
    return 100.0 * total / (t["slice_s"] * peaks.MODEL_PEAK_FLOPS)


def idle_share(ctx):
    t = ctx.trace
    if t is None or t["slice_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["slice_s"])
