#!/usr/bin/env python3
"""Host time of the unsharded fleet's hot loop, one tree against another,
on one GPU.

    python3 tools/fleet_host_ab.py [ROOT ...]

For each ROOT (a checkout of this repository; default: this one), in the
order given and each in a process of its own: builds that tree's kernels
(libraries another ROOT already built from the same sources are copied,
their names carry the sources' digest), makes granite-3-8b at full width
with bf16 weights from ``chip_smoke.SEED`` and runs that tree's
``chip_smoke.py`` control loop of phase 6 (its ``CONTROL_FLAGS``: 40
ticks, 2 nodes, graph-replayed async fleet decode, no mesh) twice. Of the
second run it reports the host milliseconds of every ``FleetGroup``
``admit_round``, ``decode_round`` and ``reconcile`` call (perf_counter
around each; under the async tick the first two only enqueue, the third
waits for the card), the tick wall, the plane's host time and the sync
wait per tick, and tok/s; then that tree's own ``_graph_report`` (the
largest group's graph-replayed dispatch alone: host and CUDA-event ms).
One JSON line per ROOT, prefixed ``[ab]``. Give the trees as parent,
change, change, parent to read a difference against the drift between
calls. Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMED = ("admit_round", "decode_round", "reconcile")


def _child(root: Path) -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("fleet_host_ab: no CUDA device")
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.models.model import make_model
    from repro_torch.serving import engine

    cs.phase_build(build)
    calls = {name: [] for name in TIMED}
    for name in TIMED:
        def timed(self, *a, _f=getattr(engine.FleetGroup, name),
                  _out=calls[name], **k):
            t0 = time.perf_counter()
            try:
                return _f(self, *a, **k)
            finally:
                _out.append((time.perf_counter() - t0) * 1e3)
        setattr(engine.FleetGroup, name, timed)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("granite-3-8b")
    model = make_model(cfg)
    params = model.init(seed=cs.SEED, dtype=torch.bfloat16, device="cuda")
    for _ in range(2):                  # the first run captures the graphs
        for c in calls.values():
            c.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = serve.run_control_loop(cs._control_args(serve), cfg, model,
                                     params, cache_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fe, plane, ticks = out["fe"], out["plane"], out["ticks"]
    n = len(ticks)
    rep = {"root": str(root), "ticks": n,
           "tok_s": sum(len(r.output) for r in fe.finished) / wall,
           "tick_ms_p50": statistics.median(t["s"] * 1e3 for t in ticks),
           "plane_host_ms_tick": sum(plane.host_s.values()) / n * 1e3,
           "sync_wait_ms_tick": fe.sync_wait_s() / n * 1e3,
           "decode_dispatches": fe.decode_dispatches(),
           "prefill_dispatches": fe.prefill_dispatches(),
           "syncs": fe.sync_count()}
    for name, c in calls.items():
        rep[name] = {"calls": len(c), "median_ms": statistics.median(c),
                     "sum_ms": sum(c)}
    graph = cs._graph_report(torch, cfg, fe)   # logs its own line
    if graph is not None:
        rep["graph_dispatch"] = graph
    rep["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    return rep


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        print("[ab] " + json.dumps(_child(Path(argv[1]).resolve())),
              flush=True)
        return 0
    roots = [Path(a).resolve() for a in argv] or [ROOT]
    built = []
    for root in roots:
        dst = root / "src" / "repro_torch" / "_build"
        dst.mkdir(parents=True, exist_ok=True)
        for lib in built:
            if not (dst / lib.name).exists():
                shutil.copy2(lib, dst / lib.name)
        rc = subprocess.run([sys.executable, __file__, "--child",
                             str(root)]).returncode
        if rc:
            return rc
        built = sorted(dst.glob("lib*.so"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
