"""One run of one cell: set-up, warm-up, the measured window, the wait for
the window's first tokens, the checks, and the result line.

Clock. The loop's clock starts after the weights are made and the system
is composed. Arrivals due in [0, warmup_s) warm the system up at the
cell's own traffic (the plane spawns its replicas, the decode graphs of
the slab sizes it reaches are captured, the prefill buckets are met);
the window is [warmup_s, warmup_s + seconds) and its arrivals are the
counted requests; arrivals keep flowing after it until every counted
request has entered, the finished ones hold a sample for the check
(``check.enough_finished``) and, in a cell that reports a
first-token tail, every counted request has its first token, or until ``drain_cap_s`` has
passed. A cell that reports no first-token tail (one above the knee,
whose queue grows) so stops as soon as its sample is in. ``setup_s`` runs
from the process's start to the window's start.

Seeds. ``--seed`` draws the weights, the order of the traffic's arrivals
and lengths, and the check's sample. Where the traffic file's ``engine``
names a ``system_seed``, that seed, and not the run's, composes the
system (the replicas' deal over the nodes, the balancer's and the
scaler's initial state), so that every run serves the same fleet under
the same plane.

End-to-end metrics (host clock): ``itl_p95_ms``, the 95th percentile of
every gap between consecutive tokens of a request whose later token came
in the window; ``output_tok_s``, the tokens that came in the window over
its seconds; ``setup_s``. The window's first-token tail, the 90th
percentile by nearest rank of every counted request's time from due to
first token (+inf for one that never got it), goes to the per-layer
readers as ``window["ttft_p90_s"]``; in a traced run it takes the
requests due before the profiled slice starts, as the profiler's stop
holds the loop for seconds and the queue it leaves lasts past the
window.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

from portbench import check, spec, stats

BANNED = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(msg, flush=True)


def banned_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


@dataclasses.dataclass
class Ctx:
    """What a per-layer reader reads."""
    cfg: dict
    window: dict
    trace: dict | None
    root: Path

    def counts(self, name: str):
        return spec.kernel_counts(self.root, name)


def arch_config(cfg: dict):
    from repro_torch.configs.base import ArchConfig

    names = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(**{k: v for k, v in cfg.items() if k in names})


def run(cell, seed: int, seconds: float, trace: bool, t_proc0: float,
        device: str = "cuda", rate: float | None = None,
        control: bool = False) -> dict:
    """One run of ``cell``; see the module docstring. ``rate`` replaces
    the traffic file's (a sweep); ``control`` also reads the float8
    control on the same sample."""
    import torch

    from portbench import loop, tracing
    from repro_torch.device import resolve_device
    from repro_torch.models.model import make_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, traffic = cell.config, cell.traffic
    eng = traffic["engine"]
    cuda = device != "cpu"
    dev = resolve_device(device)
    info = {"card": card() if cuda else "cpu"}
    if cuda:
        from repro_torch.kernels import build
        t = time.perf_counter()
        built = build.build()
        info["build_s"] = time.perf_counter() - t
        info["nvcc_s"] = {k: b.seconds for k, b in built.items()}
    model = make_model(arch_config(cfg))
    ref = cell.reference()
    t = time.perf_counter()
    weights = ref.make_weights(cfg, seed, dev, getattr(torch, cfg["dtype"]))
    if cuda:
        torch.cuda.synchronize()
    info["weights_s"] = time.perf_counter() - t
    gen = cell.generator()
    rate = traffic["rate"] if rate is None else rate
    warm, cap = traffic["warmup_s"], traffic["drain_cap_s"]
    arrivals = gen.generate(
        traffic, seed, [("warm", 0.0, warm), ("window", warm, warm + seconds),
                        ("tail", warm + seconds, warm + seconds + cap)],
        cfg["vocab_size"], rate=rate, anchor=warm)
    system = loop.System(eng, model, weights,
                         getattr(torch, cfg["cache_dtype"]), dev,
                         eng.get("system_seed", seed),
                         gen.mean_length(traffic["output"]))
    recorder = tracing.Recorder(system) if trace else None
    slicer = tracing.Slice(system, cuda) if trace else None
    if slicer is not None:
        tracing.warm_profiler(cuda)
    if cuda:
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    w0, w1 = t0 + warm, t0 + warm + seconds
    slice_s = traffic.get("trace_s", 4.0)
    s0 = w0 + max(0.0, (seconds - slice_s) / 2)
    n_window = sum(a.block == "window" for a in arrivals)
    first_tokens = any(m["name"].endswith("ttft_p90_s")
                       for m in cell.end_to_end + cell.per_layer)
    i, a_snap, b_snap, replicas, setup_peak = 0, None, None, [], 0
    window_trs: list = []
    backlog, tick_s = [], []
    while True:
        now = time.perf_counter()
        if a_snap is None and now >= w0:
            a_snap = system.counters()
            if cuda:
                setup_peak = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
        if b_snap is None and now >= w1:
            b_snap = system.counters()
        if slicer is not None:
            if slicer.start_tick is None and now >= s0:
                slicer.start()
            elif slicer.end_tick is None and slicer.start_tick is not None \
                    and now >= slicer.started + slice_s:
                slicer.stop()
        if now >= w1:
            waiting = len(window_trs) < n_window \
                or not check.enough_finished(window_trs) \
                or (first_tokens and any(not tr.stamps for tr in window_trs))
            if not waiting or now >= w1 + cap:
                break
        due = []
        while i < len(arrivals) and t0 + arrivals[i].due <= now:
            due.append((arrivals[i], t0 + arrivals[i].due))
            i += 1
        n_before = len(system.tracked)
        m = system.step(due)
        for tr in list(system.tracked.values())[n_before:]:
            if tr.block == "window":
                window_trs.append(tr)
        if a_snap is not None and b_snap is None:
            replicas.append(int(m["active_replicas"].sum()))
            backlog.append((now - w0, system.waiting()))
            tick_s.append(time.perf_counter() - now)
    t_end = time.perf_counter()
    if slicer is not None and slicer.end_tick is None \
            and slicer.start_tick is not None:
        slicer.stop()
    if cuda:
        torch.cuda.synchronize()
        window_peak = torch.cuda.max_memory_allocated()
    else:
        window_peak = 0

    # ---------------------------------------------------------- metrics
    counted = window_trs
    first = {tr.req.rid: tr.stamps[0] for tr in counted if tr.stamps}
    cut = slicer.started \
        if slicer is not None and slicer.start_tick is not None else None
    clear = [tr for tr in counted if cut is None or tr.due < cut]
    ttft = stats.ttfts({tr.req.rid: tr.due for tr in clear}, first)
    trs = list(system.tracked.values())
    gaps = [g for tr in trs for g in stats.gaps_in(tr.stamps, w0, w1)]
    toks = sum(stats.tokens_in(tr.stamps, w0, w1) for tr in trs)
    dec_toks = sum(stats.tokens_in(tr.stamps[1:], w0, w1) for tr in trs)
    e2e = {"itl_p95_ms": (stats.nearest_rank(gaps, 95) * 1e3, "ms"),
           "output_tok_s": (toks / seconds, "tokens/s"),
           "setup_s": (w0 - t_proc0, "s")}
    faults = check.ledger_faults(system, counted)
    # failed: ended unserved (refused, timed out), or, where first tokens
    # are timed, still without one at the close
    failed = sum(
        1 for tr in counted
        if system.fe.ledger.state.get(tr.req.rid) not in ("finished", "live")
        or (first_tokens and not tr.stamps))
    a, b = a_snap, b_snap or system.counters()
    window = {"ticks": b["ticks"] - a["ticks"],
              "plane_host_s": b["plane_host_s"] - a["plane_host_s"],
              "sync_wait_s": b["sync_wait_s"] - a["sync_wait_s"],
              "captures": b["captures"] - a["captures"],
              "decode_dispatches": b["decode_dispatches"]
              - a["decode_dispatches"],
              "decode_tokens": dec_toks, "replicas": replicas,
              "ttft_p90_s": stats.nearest_rank(ttft, 90)}
    end = system.counters()
    info.update({
        "rate_req_s": rate, "counted": len(counted),
        "ttft_left_out_traced": len(counted) - len(clear),
        "first_tokens": len(first), "window_tokens": toks,
        "window_ticks": window["ticks"], "wait_after_window_s": t_end - w1,
        "launches_window": {k: b["launches"][k] - a["launches"][k]
                            for k in b["launches"]},
        "dispatches_window": {k: b[k] - a[k] for k in (
            "decode_dispatches", "decode_steps", "prefill_dispatches",
            "syncs", "fetches")},
        "graphs": end["graphs"], "replicas_spawned": end["spawned"],
        "replicas_window_max": max(replicas, default=0),
        "peak_slab_rows": end["peak_slab_rows"],
        "memory_setup_peak_bytes": setup_peak,
        "memory_window_peak_bytes": window_peak,
        "backlog": stats.backlog_trend(backlog),
        "tick_ms_p50_p95": [stats.nearest_rank(tick_s, 50) * 1e3,
                            stats.nearest_rank(tick_s, 95) * 1e3]})
    traced = None
    if slicer is not None and slicer.end_tick is not None:
        t = time.perf_counter()
        slicer.reduce()
        info["trace_read_s"] = time.perf_counter() - t
        info["profiler_stop_s"] = slicer.stop_s
    if cuda and slicer is not None and slicer.result is not None:
        traced = dict(slicer.result, records=recorder.in_ticks(
            slicer.start_tick, slicer.end_tick))
        info["slice"] = {"seconds": traced["slice_s"],
                         "ticks": slicer.end_tick - slicer.start_tick,
                         "busy_s": traced["busy_s"],
                         "kernel_s": traced["kernel_s"]}
    if recorder is not None:
        recorder.remove()
    loaded = banned_modules()

    # ----------------------------------------------------------- checks
    loop.free(system)
    del system
    t = time.perf_counter()
    picked = check.sample(counted, seed)
    gap = check.served_gaps(ref, weights, cfg, picked)
    ctl = check.control_gaps(ref, weights, cfg, picked) if control else None
    info["reference_s"] = time.perf_counter() - t
    limits = cfg.get("limits", {})
    checks = {"served_gap": {"value": float(gap.max()) if gap.size
                             else math.inf,
                             "limit": limits.get("served_gap", 0.0)},
              "ledger_faults": {"value": faults, "limit": 0},
              "sampled_tokens": {"value": int(gap.size),
                                 "limit": check.SAMPLE_TOKENS // 4}}
    correct = (checks["served_gap"]["value"] <= checks["served_gap"]["limit"]
               and faults == 0 and gap.size >= check.SAMPLE_TOKENS // 4)
    return {"correct": bool(correct), "attempted": len(counted),
            "failed": failed, "e2e": e2e, "checks": checks, "info": info,
            "ctx": Ctx(cfg, window, traced, cell.root), "banned": loaded,
            "peak": max(setup_peak, window_peak),
            "control": None if ctl is None else float(ctl.max()),
            "slice": None if slicer is None else slicer.result,
            "gaps": gap}


def result_line(cell, res: dict, trace: bool, device: str) -> dict:
    """The contract's JSON object, ``checks`` last."""
    import torch

    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = spec.metric_reader(cell.root, m["name"])(res["ctx"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": res["e2e"][m["name"]][0],
                               "unit": m["unit"]} for m in cell.end_to_end}
    cuda = device != "cpu"
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(0) if cuda
                      else "cpu",
                      "count": cell.chips,
                      "memory_peak_bytes": res["peak"]}}
    t = res["ctx"].trace
    if trace and t is not None:
        out["device"].update(busy_s=t["busy_s"], window_s=t["slice_s"])
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
    out["checks"] = res["checks"]
    return out


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, root: Path, t_proc0: float) -> int:
    args = parse(argv)
    cell = spec.load_cell(root, args.workload)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"[portbench] needs {cell.chips} CUDA device(s): "
              f"available={torch.cuda.is_available()} count="
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    res = run(cell, args.seed, args.seconds, bool(args.trace), t_proc0)
    if res["banned"]:
        print(f"[portbench] JAX or the JAX package was loaded: "
              f"{res['banned']}", file=sys.stderr)
        return 4
    for k, v in res["info"].items():
        log(f"[portbench] {k}: {v}")
    out = result_line(cell, res, bool(args.trace), "cuda")
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0
