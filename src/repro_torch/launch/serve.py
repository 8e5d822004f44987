"""End-to-end serving driver of the port (``repro.launch.serve``'s twin).

Drain mode runs: ``--policy rr|lc|fractions`` with ``--autoscale none`` (the
default) sends a fixed batch of requests through the static
``ClusterFrontend`` of standalone ``ReplicaEngine``s and reports throughput,
TTFT and finish percentiles, decode steps and prefill shapes:

    PYTHONPATH=src python -m repro_torch.launch.serve --policy lc
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --requests 6

The flags and their defaults are the reference's. The model is the
reduced config of ``--arch`` with f32 weights from ``--seed``, as in the
reference; ``--device`` (default ``cuda``) names where it runs and raises
when CUDA is asked for and absent. ``--attn-backend kernel`` (the default)
runs attention through the hand-written CUDA kernels, ``einsum`` through
the reference's dense path. TF32 is off for every f32 product.

Not yet ported, and raising when asked for: the control-loop mode
(``--policy ours``, ``--autoscale``, ``--cells``, ``--hierarchy``),
``--chunk-len``, ``--devices`` and ``--mesh``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def run_drain_mode(args, cfg, model, params, cache_dtype=torch.float32,
                   workload=None):
    """Serve ``workload`` (default: ``prompt_workload(vocab, --requests,
    --seed)``) through ``--replicas`` standalone replicas behind a
    ``ClusterFrontend`` until every request finishes. Prints the report
    and returns (frontend, replicas, wall seconds)."""
    from repro_torch.data.pipeline import prompt_workload
    from repro_torch.serving.engine import (ClusterFrontend, ReplicaEngine,
                                            Request, total_prefill_traces)

    if args.no_async or args.decode_block > 1:
        print("[serve] note: --no-async/--decode-block apply to the "
              "control-loop mode only; drain mode always ticks eagerly")

    replicas = [ReplicaEngine(model, params, max_batch=args.max_batch,
                              max_seq=args.max_seq, rid=i,
                              cache_dtype=cache_dtype,
                              chunk_len=args.chunk_len,
                              attn_backend=args.attn_backend,
                              device=args.device)
                for i in range(args.replicas)]
    caps = np.ones(args.replicas)

    def fractions_fn(fe):
        loads = np.asarray([r.load for r in fe.replicas], np.float64)
        w = caps / (1.0 + loads)
        return w / w.sum()

    fe = ClusterFrontend(replicas, policy=args.policy,
                         fractions_fn=fractions_fn, seed=args.seed)
    if workload is None:
        workload = prompt_workload(cfg.vocab_size, args.requests,
                                   seed=args.seed)
    t0 = time.time()
    for w in workload:
        fe.submit(Request(w["rid"], w["prompt"],
                          max_new_tokens=w["max_new_tokens"]))
    fe.run_until_drained()
    wall = time.time() - t0
    done = fe.finished
    toks = sum(len(r.output) for r in done)
    ttft = np.array([r.first_token_time for r in done])
    lat = np.array([r.finish_time for r in done])
    print(f"[serve] {len(done)}/{len(workload)} finished, {toks} tokens in "
          f"{wall:.2f}s ({toks/wall:.1f} tok/s)")
    print(f"[serve] TTFT p50={np.percentile(ttft,50):.1f} "
          f"p95={np.percentile(ttft,95):.1f} engine-steps; "
          f"finish p50={np.percentile(lat,50):.1f} "
          f"p95={np.percentile(lat,95):.1f}")
    steps = sum(r.steps for r in replicas)
    traces = total_prefill_traces(replicas)
    print(f"[serve] decode steps across replicas: {steps} "
          f"(batch efficiency {toks/max(steps*args.max_batch,1):.2f}); "
          f"prefill shapes: {traces}")
    return fe, replicas, wall


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--policy", default="lc",
                    choices=["rr", "lc", "wrr", "fractions", "ours"])
    ap.add_argument("--autoscale", default=None,
                    choices=["none", "gpso", "ga", "hpa", "rbas", "static"])
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--replicas", type=int, default=1,
                    help="initial replicas per node (control mode) / total "
                         "replicas (drain mode)")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--ticks", type=int, default=50)
    ap.add_argument("--rate", type=float, default=2.0,
                    help="mean request arrivals per tick (control mode)")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-replicas", type=int, default=4)
    ap.add_argument("--provision-delay", type=int, default=3)
    ap.add_argument("--failure-rate", type=float, default=0.0)
    ap.add_argument("--clients", type=int, default=0,
                    help="closed-loop client count; >0 replaces the "
                         "open-loop arrival trace with a ClientPool")
    ap.add_argument("--think-time", type=float, default=2.0,
                    help="mean client think time between requests (ticks)")
    ap.add_argument("--timeout", default="8",
                    help="per-attempt deadline in ticks: scalar ('8') or "
                         "per-tier dict ('premium:4,batch:16,default:8')")
    ap.add_argument("--retries", type=int, default=3,
                    help="max retries per request before a client abandons")
    ap.add_argument("--spawn-rate", type=float, default=None,
                    help="clients activated per tick (flash-crowd ramp); "
                         "default: all at once")
    ap.add_argument("--preempt-notice", type=int, default=3,
                    help="ticks of drain notice before a preempted node's "
                         "rows are dropped (spot semantics)")
    ap.add_argument("--chaos", default="",
                    help="deterministic fault script, e.g. "
                         "'preempt@12:n0:k3,fail@8:n1:r0,recover@40:n0,"
                         "slow@5:n0:x4' (slow = straggler at 1/F speed "
                         "until 'x1' clears; multi-cell: node events land "
                         "on cell 0)")
    ap.add_argument("--cells", type=int, default=1,
                    help="federate N elastic cells behind the multi-cell "
                         "routing plane (control mode; 1 = single cell, "
                         "bit-identical to the direct frontend)")
    ap.add_argument("--cell-chaos", default="",
                    help="cell-level fault script for the routing plane, "
                         "e.g. 'cell_down@15:c0,partition@10:c1:k6,"
                         "cell_up@30:c0'; 'plane_down@10:k6'/'plane_up@20' "
                         "crash/restart the GLOBAL control plane")
    ap.add_argument("--hierarchy", action="store_true",
                    help="two-level control (needs --cells > 1): per-cell "
                         "reactive autoscalers inside GlobalPlanner "
                         "capacity leases under a crash-tolerant "
                         "PlaneSupervisor; the ControlPlane keeps "
                         "forecast+balance only")
    ap.add_argument("--plan-interval-global", type=int, default=10,
                    help="ticks between GlobalPlanner lease re-plans "
                         "(hierarchy mode)")
    ap.add_argument("--lease-slack", type=float, default=0.5,
                    help="lease headroom fraction above/below the planner "
                         "budget for local controllers to react into "
                         "(hierarchy mode)")
    ap.add_argument("--shed-threshold", type=float, default=0.0,
                    help="total-overload admission shedding: when every "
                         "healthy cell's tier pressure per unit capacity "
                         "exceeds this, shed lowest tiers first (0 = off; "
                         "multi-cell + tiers only)")
    ap.add_argument("--static-split", action="store_true",
                    help="disable adaptive cell routing (fixed uniform "
                         "split ignoring health/staleness/risk; the "
                         "multi-cell A/B baseline)")
    ap.add_argument("--no-fleet", action="store_true",
                    help="disable fleet-batched decode (per-replica jit "
                         "dispatch loop; A/B baseline)")
    ap.add_argument("--no-fleet-prefill", action="store_true",
                    help="disable fleet-batched admission (per-replica "
                         "prefill dispatches; A/B baseline)")
    ap.add_argument("--no-async", action="store_true",
                    help="disable the overlapped async tick (eager blocking "
                         "syncs after every dispatch; bit-exact parity "
                         "oracle)")
    ap.add_argument("--decode-block", type=int, default=1,
                    help="fuse K decode micro-steps into one dispatch+sync "
                         "on ticks that admit nothing (async mode; 1 = one "
                         "step per tick; >1 trades <= K-1 ticks of "
                         "admission lag under a full slab)")
    ap.add_argument("--attn-backend", default="kernel",
                    choices=["kernel", "einsum"],
                    help="attention backend: the hand-written CUDA kernels "
                         "(flash-attention prefill, flash-decode; their "
                         "plain versions on the CPU) or the dense einsum "
                         "reference")
    ap.add_argument("--chunk-len", type=int, default=0,
                    help="chunked-prefill width: prompts longer than this "
                         "admit in fixed-size chunks interleaved with decode "
                         "(0 = single-shot prefill)")
    ap.add_argument("--tiers", default="",
                    help="SLO tier mix 'name:share:wWEIGHT[:ttft],...' e.g. "
                         "'premium:0.2:w5:4,standard:0.5:w2,batch:0.3:w1' — "
                         "share of traffic, weighted-deficit admission "
                         "weight, optional TTFT target in ticks (control "
                         "mode; default: single tier, identical to the "
                         "untiered scheduler)")
    ap.add_argument("--devices", type=int, default=0,
                    help="shard fleet slabs over N devices (not yet "
                         "ported; 0 = unsharded)")
    ap.add_argument("--mesh", default="",
                    help="explicit serving mesh spec (not yet ported)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device the replicas run on; 'cuda' raises "
                         "when no CUDA device is present (pass 'cpu' to run "
                         "on the CPU)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    control_mode = (args.policy == "ours"
                    or (args.autoscale or "none") != "none"
                    or args.cells > 1 or args.hierarchy)
    if control_mode:
        raise SystemExit("[serve] the control-loop mode (--policy ours, "
                         "--autoscale, --cells, --hierarchy) is not yet "
                         "ported; drain mode is --policy rr|lc|fractions")
    if args.devices > 0 or args.mesh:
        raise SystemExit("[serve] --devices/--mesh are not yet ported")

    from repro_torch.configs import get_config
    from repro_torch.models.model import make_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch).reduced()
    model = make_model(cfg, tp=1)
    params = model.init(seed=args.seed, dtype=torch.float32,
                        device=args.device)
    print(f"[serve] arch={cfg.name} policy={args.policy} "
          f"device={args.device} attn-backend={args.attn_backend}")
    if args.policy == "wrr":
        args.policy = "fractions"
    run_drain_mode(args, cfg, model, params)


if __name__ == "__main__":
    main()
