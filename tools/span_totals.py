#!/usr/bin/env python3
"""The program's span and counter totals (``repro_torch.telemetry``) over
the timed window of one benchmark run, and over its profiled slice.

    python3 tools/span_totals.py --workload granite-3-8b.chat --seed 7 \
        --seconds 51 --trace 0 [--device cpu] [--out FILE]

Runs the cell as ``portbench/run.py`` does (``portbench.harness.run``) and
snapshots the registry where the harness reads the program's counters at
the window's start and end (its first two ``System.counters()`` calls), so
the totals cover the ticks that the window's readers
(``plane.host_ms_per_tick``, ``frontend.sync_wait_ms_per_tick``) cover.
Prints one JSON object (and writes it to ``--out``): the card, the
harness's result line, its info lines and its window's counters
(``harness_window``), and ``window``: its ticks, each span's ms a tick,
ms a call and calls, each counter's total. With
``--trace 1`` the window holds the profiled slice, whose spans also open
``record_function`` and so carry the profiler's cost: ``session`` gives
the slice alone (``telemetry.session()``, which the traced readers read)
and ``window_less_session`` the rest of the window. Needs the cell's CUDA
devices unless ``--device cpu``; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def totals(a: tuple, b: tuple) -> dict:
    """The change from registry snapshot ``a`` to ``b`` (each ``(spans,
    counters)``), per tick of the ``plane.step`` spans between them."""
    (s0, c0), (s1, c1) = a, b
    ticks = s1.get("plane.step", (0.0, 0))[1] \
        - s0.get("plane.step", (0.0, 0))[1]
    spans = {}
    for k, (sec, n) in sorted(s1.items()):
        sa, na = s0.get(k, (0.0, 0))
        if n > na:
            spans[k] = {"ms_per_tick": (sec - sa) / ticks * 1e3
                        if ticks else None,
                        "ms_per_call": (sec - sa) / (n - na) * 1e3,
                        "calls": n - na}
    counters = {k: v - c0.get(k, 0) for k, v in sorted(c1.items())
                if v != c0.get(k, 0)}
    return {"ticks": ticks, "spans": spans, "counters": counters}


def measure(cell, seed: int, seconds: float, trace: bool,
            device: str = "cuda") -> dict:
    """One run of ``cell`` with the registry read at the window's ends;
    see the module docstring."""
    from portbench import harness, loop
    from repro_torch import telemetry

    snaps = []
    real = loop.System.counters

    def counters(self):
        if len(snaps) < 2:
            snaps.append(telemetry._REG.snapshot())
        return real(self)

    loop.System.counters = counters
    try:
        res = harness.run(cell, seed, seconds, trace, time.perf_counter(),
                          device=device)
    finally:
        loop.System.counters = real
    out = {"card": res["info"]["card"],
           "result": harness.result_line(cell, res, trace, device),
           "info": res["info"],
           "harness_window": {k: v for k, v in res["ctx"].window.items()
                              if not isinstance(v, list)},
           "window": totals(*snaps)}
    if trace:
        s = telemetry.session()
        out["session"] = totals(({}, {}), (s.spans, s.counters))
        (s1, c1) = snaps[1]
        less = ({k: (sec - s.spans.get(k, (0.0, 0))[0],
                     n - s.spans.get(k, (0.0, 0))[1])
                 for k, (sec, n) in s1.items()},
                {k: v - s.counters.get(k, 0) for k, v in c1.items()})
        out["window_less_session"] = totals(snaps[0], less)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import spec

    cell = spec.load_cell(ROOT, args.workload)
    out = measure(cell, args.seed, args.seconds, bool(args.trace),
                  args.device)
    text = json.dumps(out, default=str)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
