"""The traced slice of a ``--trace 1`` run: spans around the calls into
each layer, the dispatches' work records, and the reduction of the
profiler's trace to device busy time, kernel times and idle gaps.

Spans (``torch.profiler.record_function``, from these files, around the
program's methods): ``plane.step``, ``plane.forecast``, ``plane.balance``,
``plane.scale``, ``frontend.tick``, ``engine.admit_round``,
``engine.fleet_prefill``, ``engine.decode_round``, ``engine.reconcile``,
``bench.stamp``, and ``bench.slice`` over the whole slice. They name the
host's work under each idle gap of the device.

Work records, one a dispatch, tagged with the tick that issued it: a fleet
prefill's real prompt lengths (``FleetGroup._dispatch_fleet_prefill``),
and a fleet decode's rows that stepped with the positions they read, from
the step mask the device returns (``FleetGroup._apply_decode``, in
dispatch order, so each result is matched to its dispatch's tick). The
slice's kernels are the launches of the ticks inside it: it starts and
ends on a tick boundary behind ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import collections
import functools
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
KERNELS = ("flash_decode", "flash_attention", "ssd_scan", "gcn")


def _spanned(obj, attr: str, span: str) -> None:
    fn = getattr(obj, attr)

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with torch.profiler.record_function(span):
            return fn(*a, **kw)
    setattr(obj, attr, wrapped)


class Recorder:
    """Installs the spans and the work records on one ``System``."""

    def __init__(self, system):
        from repro_torch.serving import engine

        self.system = system
        self.records: list = []          # (kind, tick, [lengths])
        self._fifo: dict = collections.defaultdict(collections.deque)
        plane, fe = system.plane, system.fe
        for attr, span in (("step", "plane.step"),
                           ("_forecast", "plane.forecast"),
                           ("_balance", "plane.balance"),
                           ("_scale", "plane.scale")):
            _spanned(plane, attr, span)
        _spanned(fe, "tick", "frontend.tick")
        _spanned(system, "stamp", "bench.stamp")
        G = engine.FleetGroup
        self._saved = {n: getattr(G, n) for n in
                       ("admit_round", "_dispatch_fleet_prefill",
                        "decode_round", "reconcile", "_decode_round_async",
                        "_apply_decode")}
        rec = self

        def span(name, fn):
            def wrapped(*a, **kw):
                with torch.profiler.record_function(name):
                    return fn(*a, **kw)
            return wrapped

        def prefill(g, sb, entries, finished):
            rec.records.append(("prefill", system.ticks,
                                [len(e[3]) for e in entries]))
            return rec._saved["_dispatch_fleet_prefill"](g, sb, entries,
                                                         finished)

        def decode_async(g, movers, allow_block):
            n = len(g.pending)
            out = rec._saved["_decode_round_async"](g, movers, allow_block)
            if len(g.pending) > n and g.pending[-1].kind == "decode":
                rec._fifo[id(g)].append(system.ticks)
            return out

        def apply_decode(g, arrays, meta, finished):
            stepped = arrays[2]
            kv = [int(e.pos[s]) + 1 for e, row, _ in meta
                  for s in range(stepped.shape[1]) if stepped[row][s]]
            rec.records.append(("decode", rec._fifo[id(g)].popleft(), kv))
            return rec._saved["_apply_decode"](g, arrays, meta, finished)

        G.admit_round = span("engine.admit_round", self._saved["admit_round"])
        G._dispatch_fleet_prefill = span("engine.fleet_prefill", prefill)
        G.decode_round = span("engine.decode_round",
                              self._saved["decode_round"])
        G.reconcile = span("engine.reconcile", self._saved["reconcile"])
        G._decode_round_async = decode_async
        G._apply_decode = apply_decode

    def remove(self) -> None:
        from repro_torch.serving import engine

        for n, fn in self._saved.items():
            setattr(engine.FleetGroup, n, fn)

    def in_ticks(self, lo: int, hi: int) -> list:
        """The records of dispatches issued in ticks [lo, hi)."""
        return [r for r in self.records if lo <= r[1] < hi]


class Slice:
    """``torch.profiler`` over ticks [start_tick, end_tick), bounded by
    synchronisations, its trace reduced when it stops."""

    def __init__(self, system, cuda: bool = True):
        self.system = system
        self.cuda = cuda
        self.prof = None
        self.start_tick = self.end_tick = None
        self.result = None

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def start(self) -> None:
        self._sync()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._span = torch.profiler.record_function("bench.slice")
        self._span.__enter__()
        self.start_tick = self.system.ticks
        self.started = time.perf_counter()

    def stop(self) -> None:
        """Stops the profiler; its trace is read later (``reduce``), after
        the loop, so that reading it stalls no tick."""
        self._sync()
        self._span.__exit__(None, None, None)
        t = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.stop_s = time.perf_counter() - t
        self.end_tick = self.system.ticks

    def reduce(self) -> dict:
        fd, path = tempfile.mkstemp(prefix="portbench-trace-",
                                    suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        self.result = reduce_trace(events)
        return self.result


def warm_profiler(cuda: bool) -> None:
    """Start and stop the profiler once in set-up, so that its first
    start (its own set-up, CUPTI's on a card) falls outside the window."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        torch.zeros(1, device="cuda" if cuda else "cpu").add_(1)
        if cuda:
            torch.cuda.synchronize()


def kernel_of(name: str):
    low = name.lower()
    for k in KERNELS:
        if k in low:
            return "gcn_layer" if k == "gcn" else k
    return None


def _union(intervals: list) -> float:
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def reduce_trace(events: list) -> dict:
    """From a chrome trace: the slice's bounds and seconds, the device's
    busy seconds (the union of kernel, copy and set intervals inside the
    slice), each kernel's device seconds, the device operations that took
    most time, and the longest idle gaps, each named by the innermost
    host span (else host operation) open at its middle."""
    sl = next(e for e in events if e.get("name") == "bench.slice"
              and e.get("cat") == "user_annotation")
    lo, hi = sl["ts"], sl["ts"] + sl["dur"]
    dev, per_kernel, per_op = [], collections.Counter(), collections.Counter()
    host = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = e["ts"], e["ts"] + e["dur"]
        if e.get("cat") in DEVICE_CATS:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            dev.append((a, b))
            per_op[e["name"]] += (b - a) * 1e-6
            k = kernel_of(e["name"])
            if k:
                per_kernel[k] += (b - a) * 1e-6
        elif e.get("cat") in ("user_annotation", "cpu_op") and a < hi \
                and b > lo and e.get("name") != "bench.slice":
            host.append((a, b, e["cat"] == "user_annotation", e["name"]))
    busy = _union(dev) * 1e-6
    dev.sort()
    gaps, end = [], lo
    for a, b in dev:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:10]:
        mid = (a + b) / 2
        over = [h for h in host if h[0] <= mid < h[1]]
        spans = [h for h in over if h[2]] or over
        name = min(spans, key=lambda h: h[1] - h[0])[3] if spans \
            else "host.idle"
        named.append([name, (b - a) * 1e-6])
    return {"slice_s": (hi - lo) * 1e-6, "busy_s": busy,
            "kernel_s": dict(per_kernel),
            "device_ops": [[n[:120], s] for n, s in per_op.most_common(10)],
            "idle_gaps": named}
