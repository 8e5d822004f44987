#!/usr/bin/env python3
"""Explore a cell outside the benchmark's runs, in one process: each rate
of ``--rates`` (the knee sweep: the highest rate at which the window's
backlog does not grow) and each seed of ``--seeds`` is one run of the
harness, printed as one JSON line; ``--control`` also reads the float8
control on each run's sample (the upper reading of ``served_gap``).

    python3 portbench/sweep.py --workload granite-3-8b.chat \
        --rates 2,3,4,6 --seeds 101 --seconds 20

``--paired`` runs the i-th rate with the i-th seed (as many of each)
instead of every seed at every rate.
"""
import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", default="")
    ap.add_argument("--seeds", default="101")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--paired", action="store_true")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import harness, spec

    cell = spec.load_cell(ROOT, args.workload)
    rates = [float(r) for r in args.rates.split(",") if r] or [None]
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.paired:
        runs = list(zip(seeds, rates, strict=True))
    else:
        runs = [(seed, rate) for seed in seeds for rate in rates]
    for seed, rate in runs:
        t = time.perf_counter()
        res = harness.run(cell, seed, args.seconds, bool(args.trace),
                          t, rate=rate, control=args.control)
        line = harness.result_line(cell, res, bool(args.trace), "cuda")
        if args.trace:
            line["e2e"] = {k: v[0] for k, v in res["e2e"].items()}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "rate": rate, "info": res["info"],
                          "control_gap": res["control"],
                          "ttft_p90_s": res["ctx"].window["ttft_p90_s"],
                          "result": line}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
