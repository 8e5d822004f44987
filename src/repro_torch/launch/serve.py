"""End-to-end serving driver of the port (``repro.launch.serve``'s twin).

Two modes, with the reference's flags and defaults:

  * **Unified control loop** (the paper's system) -- when ``--autoscale`` is
    set or ``--policy ours``: an ``ElasticClusterFrontend`` of
    heterogeneous ``ReplicaEngine``s (cold-start provisioning, graceful
    drain, failure injection), fleet-batched with the async tick by
    default, driven by the ``ControlPlane`` (forecast -> balance -> scale)
    over a bursty synthetic trace:

        PYTHONPATH=src python -m repro_torch.launch.serve --policy ours \
            --autoscale gpso --ticks 60
        PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
            --policy ours --autoscale gpso --ticks 10

    ``--policy ours`` runs the GCN+DDPG balancer acting greedily (its
    whole action one launch of the GCN kernel, where the graph fits one
    block); ``--autoscale gpso`` runs the Eq.9-11 GPSO planner. The control
    plane's tensors live on ``--device``; on a card the plane runs on a
    CUDA stream of its own.

  * **Drain mode** -- ``--policy rr|lc|fractions`` with ``--autoscale
    none`` (the default): a fixed batch of requests through the static
    ``ClusterFrontend`` of standalone replicas, reporting throughput, TTFT
    and finish percentiles, decode steps and prefill shapes.

The control loop takes the reference's robustness and federation flags:
``--clients N`` (closed-loop clients with ``--think-time``, ``--timeout``,
``--retries``, ``--spawn-rate`` replace the open-loop trace), ``--cells N``
(the multi-cell routing plane, with ``--cell-chaos``, ``--shed-threshold``,
``--static-split``), ``--hierarchy`` (per-cell autoscalers under the
global planner's leases, ``--plan-interval-global``, ``--lease-slack``) and
``--decode-block K`` (K fused decode micro-steps a dispatch on ticks that
admit nothing). ``--chunk-len N`` (both modes) streams prompts longer than
N tokens in N-token chunks interleaved with decode, with an f32 cache (the
reduced config's); a bf16 or int8 cache keeps single-shot prefill, as in
the reference. The int8 KV cache has no flag, as in the reference: it is
reached through the engine API (``ReplicaEngine(cache_dtype="int8")``).

On a card every decode dispatch replays a captured CUDA graph (the fleet's
one or K micro-steps, a drain-mode replica's step); ``--no-async`` is the
eager oracle (eager decode, blocking syncs). On the CPU everything runs
eagerly.

The model is the reduced config of ``--arch`` with f32 weights from
``--seed``, as in the reference; ``--device`` (default ``cuda``) names
where it runs and raises when CUDA is asked for and absent.
``--attn-backend pallas`` (the port's default; the reference's is
``einsum``) runs attention through the hand-written CUDA kernels -- the
reference's name for its kernel path, which is Pallas there -- and
``einsum`` through the reference's dense path.
TF32 is off for every f32 product.

Device scaling: ``--devices N`` splits every fleet group's slab rows over
an N-way ``('fleet',)`` mesh (``launch.mesh``): shard d on ``cuda:d``, and
fewer than N cards is an error (never N shards on fewer cards). With
``--device cpu`` the N shards are virtual, all on the CPU, as the
reference's virtual host devices are; streams, clocks and dispatch/sync
counts equal the unsharded run's. ``--mesh SPEC`` passes an explicit
mesh spec over the visible devices instead: ``'4:fleet'``, or with the
data-like and ``model`` axes, ``'2x2:fleet,model'`` (each replica's
heads over two devices), ``'2x2:fleet,data'``, ``'1x2x2:fleet,data,
model'`` (``FleetGroup``'s shard contract); with ``--device cpu`` its
devices are virtual, as many as the spec names. Both apply to the
control loop; drain mode notes that and runs its standalone replicas.

The CLI refuses the vlm and audio families, as the reference's CLI fails
on them (their requests carry extras its workload does not make); both
serve through the engine API, standalone or as a fleet.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _percentiles(xs, qs=(50, 95)):
    xs = np.asarray(xs, np.float64)
    return [float(np.percentile(xs, q)) for q in qs]


def _parse_timeout(spec: str):
    """'8' -> scalar ticks; 'premium:4,batch:16' -> per-tier dict."""
    try:
        return float(spec)
    except ValueError:
        out = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            name, _, val = part.partition(":")
            if not val:
                raise ValueError(f"bad timeout entry {part!r}")
            out[name] = float(val)
        return out


# families whose requests carry per-request extras that the CLI's workload
# does not make: the reference's CLI fails on them too (KeyError on the
# extra), and both packages serve them through the engine API
_EXTRAS = {"vlm": "patch_embeds", "audio": "frame_embeds"}


def unported(args) -> str:
    """The first flag of ``args`` that asks for a path the CLI does not
    serve, or an empty string."""
    from repro_torch.configs import REGISTRY

    cfg = REGISTRY.get(args.arch)   # callers may pass a reduced config's name
    fam = cfg.family if cfg is not None else None
    if fam in _EXTRAS:
        return (f"--arch {args.arch} on the CLI (a {fam} request carries a "
                f"{_EXTRAS[fam]!r} extra the CLI's workload does not make; "
                "serve it through ReplicaEngine with Request.extras)")
    return ""


def cluster_config(args):
    """The control loop's ``ClusterConfig`` from the serve flags, as
    ``repro.launch.serve`` builds it: with ``--cells > 1`` the plane sees
    the cells as its nodes, and a scale target is a cell's total replica
    budget."""
    from repro_torch.configs.paper_cluster import ClusterConfig

    multi = args.cells > 1
    return ClusterConfig(
        num_nodes=args.cells if multi else args.nodes,
        horizon=8, forecast_window=16,
        provisioning_delay=args.provision_delay,
        max_replicas_per_node=(args.nodes * args.max_replicas
                               if multi else args.max_replicas),
        min_replicas_per_node=1,      # never plan a node to zero capacity
        scale_interval=5, cooldown=8, straggler_prob=0.0, node_mtbf=1e12)


def run_control_loop(args, cfg, model, params, cache_dtype=torch.float32,
                     rl=None, scaler_key=None, mesh=None) -> dict:
    """The control loop of ``repro.launch.serve`` over ``model``/
    ``params``: ``--ticks`` ticks of the plane (under ``--hierarchy``, of
    the ``PlaneSupervisor``) over the trace or the closed-loop clients,
    then drain, on one elastic cell or a federation of ``--cells``. ``rl``
    (an ``RLBalancer``) and ``scaler_key`` (a GPSO key, see ``core.gpso``)
    replace the ones drawn from ``--seed`` (the tests pass the
    reference's); ``mesh`` (a ``launch.mesh.Mesh`` with a ``fleet`` axis)
    splits every fleet group's slab over its shards. Prints the
    reference's report lines plus the plane's;
    returns {"fe", "plane", "pool", "sup", "ticks" (per tick: replicas,
    fractions, dispatch and sync counts, the async tick's sync accounting,
    host seconds), "wall"}."""
    from repro_torch.control import (CellController, CellRouter,
                                     ControlPlane, GlobalPlanner,
                                     MultiCellBackend, PlaneSupervisor)
    from repro_torch.core import balancer as bal
    from repro_torch.serving.elastic import (ChaosSchedule,
                                             ElasticClusterFrontend)
    from repro_torch.serving.engine import ReplicaEngine, Request
    from repro_torch.workload.clients import ClientPool
    from repro_torch.workload.trace import (TraceConfig, generate_trace,
                                            parse_tiers)

    what = unported(args)
    if what:
        raise SystemExit(f"[serve] {what} is not yet ported")
    tiers = parse_tiers(args.tiers)
    multi = args.cells > 1
    if args.hierarchy and not multi:
        raise SystemExit("--hierarchy needs --cells > 1 (the two-level "
                         "split is over a federation of cells)")
    ccfg = cluster_config(args)
    rng = np.random.default_rng(args.seed)

    def make_replica(rid: int) -> ReplicaEngine:
        # heterogeneous pool: mixed hardware generations + batch budgets
        speed = float(rng.choice([0.7, 1.0, 1.4]))
        mb = int(rng.choice([max(2, args.max_batch // 2), args.max_batch]))
        return ReplicaEngine(model, params, max_batch=mb,
                             max_seq=args.max_seq, rid=rid, speed=speed,
                             cache_dtype=cache_dtype,
                             chunk_len=args.chunk_len, tiers=tiers,
                             attn_backend=args.attn_backend,
                             device=args.device,
                             decode_graph=not args.no_async)

    def request_factory(rid: int, tick: int) -> Request:
        plen = int(rng.integers(2, 12))
        req = Request(rid, rng.integers(1, cfg.vocab_size, plen).tolist(),
                      max_new_tokens=int(rng.integers(4, 12)))
        if len(tiers) > 1:     # single-tier: no extra rng draw
            req.tier = tiers.sample(rng)
        return req

    est_tokens = 8.0
    chaos = ChaosSchedule.parse(args.chaos) if args.chaos else None

    def build_cell(cell_chaos):
        return ElasticClusterFrontend(
            make_replica, args.nodes, initial_replicas=args.replicas,
            provisioning_delay=args.provision_delay,
            max_replicas_per_node=args.max_replicas,
            failure_rate=args.failure_rate, request_factory=request_factory,
            seed=args.seed, est_tokens=est_tokens,
            fleet_batch=not args.no_fleet,
            fleet_prefill=not args.no_fleet_prefill,
            async_tick=not args.no_async, decode_block=args.decode_block,
            tiers=tiers, mesh=mesh, preempt_notice=args.preempt_notice,
            chaos=cell_chaos)

    if multi:
        # node-level --chaos lands on cell 0 (the scripted victim); cell
        # events drive the router
        cell_chaos = ChaosSchedule.parse(args.cell_chaos) \
            if args.cell_chaos else None
        router = CellRouter(args.cells, tiers=tiers,
                            shed_threshold=args.shed_threshold or None,
                            adaptive=not args.static_split)
        fe = MultiCellBackend(
            [build_cell(chaos if c == 0 else None)
             for c in range(args.cells)],
            tiers=tiers, router=router, chaos=cell_chaos,
            request_factory=request_factory, seed=args.seed)
    else:
        fe = build_cell(chaos)
    pool = None
    if args.clients > 0:
        # closed loop: the pool replaces the open-loop arrival trace (the
        # frontend's request_factory goes unused at arrival_rate 0)
        pool = ClientPool(
            fe, args.clients, request_factory=request_factory,
            think_time=args.think_time,
            timeout=_parse_timeout(args.timeout),
            max_retries=args.retries, spawn_rate=args.spawn_rate,
            seed=args.seed + 1)

    balancer = {"ours": "rl", "rr": "rr", "lc": "lc", "wrr": "wrr",
                "fractions": "wrr"}[args.policy]
    if balancer != "rl":
        rl = None
    elif rl is None:
        rl = bal.RLBalancer(ccfg, 4 + ccfg.horizon, seed=args.seed,
                            device=args.device)
    unit_cap = args.max_batch / est_tokens     # replica requests/tick
    trace = generate_trace(TraceConfig(ticks=args.ticks, base_rate=args.rate,
                                       diurnal_period=max(args.ticks, 2)),
                           seed=args.seed)
    arrivals = trace["arrivals"]
    # hierarchy mode: the ControlPlane keeps forecast + balance, scaling
    # authority moves to the per-cell controllers under leases
    plane = ControlPlane(ccfg, fe, balancer=balancer,
                         scaler="none" if args.hierarchy else args.autoscale,
                         unit_capacity=unit_cap, rl=rl,
                         forecast_scale=float(arrivals.mean()),
                         seed=args.seed,
                         init_arrival=float(arrivals[:5].mean()),
                         device=args.device)
    if scaler_key is not None and plane.scaler is not None:
        plane.scaler.key = scaler_key
    sup = None
    if args.hierarchy:
        cell_cap = args.nodes * args.max_replicas
        planner = GlobalPlanner(args.cells,
                                total_budget=args.cells * cell_cap,
                                max_per_cell=cell_cap,
                                lease_slack=args.lease_slack)
        controllers = [CellController(fe, c) for c in range(args.cells)]
        sup = PlaneSupervisor(fe, planner, controllers, plane=plane,
                              plan_interval=args.plan_interval_global)

    print(f"[serve] unified loop: balancer={balancer} "
          f"autoscale={args.autoscale} nodes={args.nodes} "
          f"ticks={args.ticks} device={args.device}"
          + (f" actor={rl.actor}" if rl is not None else "")
          + (f" cells={args.cells}" if multi else "")
          + (" hierarchy=on"
             f" plan-interval={args.plan_interval_global}" if sup else "")
          + (f" clients={args.clients}" if pool else "")
          + (f" chaos={args.chaos!r}" if chaos else "")
          + (f" cell-chaos={args.cell_chaos!r}"
             if multi and args.cell_chaos else ""))
    ticks = []
    t0 = time.time()
    for t in range(args.ticks):
        t1 = time.perf_counter()
        if pool is not None:
            pool.tick()                     # closed loop drives arrivals
        rate = 0.0 if pool is not None else float(arrivals[t])
        if sup is not None:
            m = sup.step(rate)
        elif getattr(fe, "plane_alive", True):
            m = plane.step(rate)
        else:
            # centralized loop under a plane outage: the one brain is gone
            # -- tick the data plane, no planning/balancing/scaling
            m = fe.tick(rate)
        ticks.append({"s": time.perf_counter() - t1,
                      "replicas": m["active_replicas"].tolist(),
                      "fractions": plane.fractions.copy(),
                      "decode_dispatches": m["decode_dispatches"],
                      "prefill_dispatches": m["prefill_dispatches"],
                      "syncs": m["syncs"],
                      "reconciles": m.get("reconciles"),
                      "replica_syncs": m.get("replica_syncs"),
                      "last_round_dispatches": m.get(
                          "last_round_dispatches"),
                      "in_flight_groups": m.get("in_flight_groups")})
        if t % 10 == 0 or t == args.ticks - 1:
            print(f"[serve] t={t:3d} arrivals={arrivals[t]:5.1f}/tick "
                  f"replicas={m['active_replicas'].tolist()} "
                  f"queue={m['queue'].astype(int).tolist()} "
                  f"util={m['mean_utilization']:.2f} "
                  f"resp={m['response_time']:.1f}t "
                  f"goodput={m['goodput']:.0f}")
    if pool is not None:
        pool.quiesce()
    fe.run_until_drained()
    if pool is not None:
        pool.finalize()
    wall = time.time() - t0

    done = fe.finished
    toks = sum(len(r.output) for r in done)
    print(f"[serve] {len(done)} requests, {toks} tokens in {wall:.2f}s "
          f"({toks / max(wall, 1e-9):.1f} tok/s); "
          f"replicas spawned={fe.replicas_spawned} "
          f"failed={fe.failed_replicas} "
          f"replica-ticks={fe.replica_ticks} "
          f"decode-dispatches={fe.decode_dispatches()} "
          f"prefill-dispatches={fe.prefill_dispatches()} "
          f"syncs={fe.sync_count()} "
          f"sync-wait={fe.sync_wait_s():.2f}s")
    # queue-culled deadline expiries land in fe.finished with NO first
    # token -- latency stats are over requests that were actually served
    served = [r for r in done if r.first_token_time is not None]
    if served:
        ttft = _percentiles([r.first_token_time - r.arrival
                             for r in served])
        lat = _percentiles([r.finish_time - r.arrival for r in served])
        print(f"[serve] TTFT p50={ttft[0]:.1f} p95={ttft[1]:.1f} ticks; "
              f"latency p50={lat[0]:.1f} p95={lat[1]:.1f} ticks; "
              f"prefill shapes={fe.prefill_retraces()}")
        if len(tiers) > 1:
            for spec in tiers.specs:
                sub = [r for r in served if tiers.index(r.tier)
                       == tiers.index(spec.name)]
                if not sub:
                    continue
                tt = _percentiles([r.first_token_time - r.arrival
                                   for r in sub])
                att = ""
                if np.isfinite(spec.ttft_target):
                    ok = np.mean([r.first_token_time - r.arrival
                                  <= spec.ttft_target for r in sub])
                    att = f" SLO({spec.ttft_target:g}t)={ok:.0%}"
                print(f"[serve]   tier {spec.name:<10} n={len(sub):4d} "
                      f"TTFT p50={tt[0]:.1f} p95={tt[1]:.1f}{att}")
    n = max(len(ticks), 1)
    hs = plane.host_s
    print(f"[serve] plane host ms/tick: forecast={hs['forecast'] / n * 1e3:.2f}"
          f" balance={hs['balance'] / n * 1e3:.2f} "
          f"scale={hs['scale'] / n * 1e3:.2f}; fetches={plane.fetches} "
          f"fetch-wait={plane.fetch_wait:.3f}s")

    led = fe.ledger
    states = led.balance()
    print(f"[serve] ledger: submitted={led.submitted} "
          f"finished={states['finished']} timed_out={states['timed_out']} "
          f"abandoned={states['abandoned']} rejected={states['rejected']} "
          f"shed={states['shed']} "
          f"retries={led.retries} duplicates={led.duplicates} "
          f"wasted={led.wasted} double_served={led.double_served} "
          f"balanced={led.balanced()}")
    for tname, row in sorted(led.per_tier.items()):
        total = max(row["finished"] + row["timed_out"]
                    + row["abandoned"] + row["rejected"], 1)
        print(f"[serve]   ledger tier {tname:<10} "
              f"goodput={row['finished']}/{total} "
              f"({row['finished'] / total:.0%}) "
              f"timed_out={row['timed_out']} abandoned={row['abandoned']} "
              f"rejected={row['rejected']} shed={row['shed']} "
              f"retries={row['retries']}")
    if fe.preempted_nodes or fe.preempted_replicas:
        print(f"[serve] preemptions: nodes={fe.preempted_nodes} "
              f"replicas={fe.preempted_replicas}")
    if multi:
        # degraded-mode report: what the routing plane absorbed
        stale = fe.cell_staleness().astype(int).tolist()
        print(f"[serve] cells: downs={fe.cell_downs} "
              f"evacuated={fe.evacuated_total} shed={fe.shed_total} "
              f"quarantine-ticks={fe.quarantine_ticks} "
              f"parked={len(fe.pending)} staleness={stale} "
              f"weights={np.round(fe._weights, 3).tolist()}")
        if fe.plane_outages:
            print(f"[serve] plane: outages={fe.plane_outages} "
                  f"dark-ticks={fe.plane_outage_ticks} "
                  f"local-actions={fe.local_actions_total}")
        if sup is not None:
            hs = sup.summary()
            print(f"[serve] hierarchy: plans={hs['plans']} "
                  f"local-actions={hs['local_actions']} "
                  f"(up={hs['local_up_actions']}) "
                  f"outage-steps={hs['outage_steps']} "
                  f"restores={hs['restores']} "
                  f"leases={hs['leases']}")
    if pool is not None:
        s = pool.summary()
        lm = s["latency_mean"]
        lp = s["latency_p95"]
        print(f"[serve] clients: n={s['clients']} issued={s['issued']} "
              f"ok={s['ok']} timed_out={s['timed_out']} "
              f"retries={s['retries']} abandoned={s['abandoned']} "
              f"rejected={s['rejected']} shed={s['shed']}"
              + (f" e2e mean={lm:.1f}t p95={lp:.1f}t"
                 if lm is not None else ""))
        for tname, row in sorted(s["per_tier"].items()):
            n_rids = max(row["ok"] + row["abandoned"], 1)
            print(f"[serve]   clients tier {tname:<10} "
                  f"goodput={row['ok']}/{n_rids} "
                  f"({row['ok'] / n_rids:.0%}) "
                  f"retries={row['retries']} abandoned={row['abandoned']}")
    return {"fe": fe, "plane": plane, "pool": pool, "sup": sup,
            "ticks": ticks, "wall": wall}


def run_drain_mode(args, cfg, model, params, cache_dtype=torch.float32,
                   workload=None, decode_graph=True):
    """Serve ``workload`` (default: ``prompt_workload(vocab, --requests,
    --seed)``) through ``--replicas`` standalone replicas behind a
    ``ClusterFrontend`` until every request finishes; on a card each
    decode step replays the replica's captured graph (``decode_graph=
    False``: eager, the oracle). Prints the report and returns (frontend,
    replicas, wall seconds)."""
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
                              device=args.device, decode_graph=decode_graph)
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
    ap.add_argument("--attn-backend", default="pallas",
                    choices=["einsum", "pallas"],
                    help="attention backend: 'pallas', the reference's "
                         "name for the kernel path, here the hand-written "
                         "CUDA kernels (flash-attention prefill, "
                         "flash-decode, the SSD scan; their plain versions "
                         "on the CPU), or the dense einsum reference")
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
                    help="shard fleet slabs over an N-way ('fleet',) mesh: "
                         "cuda:0..N-1 (fewer cards is an error), or N "
                         "virtual shards with --device cpu (0 = unsharded)")
    ap.add_argument("--mesh", default="",
                    help="explicit serving mesh spec 'SHAPE:AXES' (e.g. "
                         "'4:fleet') over the visible devices; must "
                         "include a 'fleet' axis. Overrides --devices' "
                         "mesh shape but not its virtual-device setup")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device the replicas and the control "
                         "plane run on; 'cuda' raises when no CUDA device "
                         "is present (pass 'cpu' to run on the CPU)")
    return ap


def serve_mesh(args):
    """The serving mesh that ``--devices`` / ``--mesh`` ask for, or None.
    With ``--device cpu`` the devices are virtual: the host device count
    (``--devices``, else the size of ``--mesh``'s spec) is set while the
    mesh is built and restored after."""
    if not (args.devices > 0 or args.mesh):
        return None
    from repro_torch.launch.mesh import (host_device_count, make_fleet_mesh,
                                         parse_mesh_spec)

    count = None
    if torch.device(args.device).type == "cpu":   # virtual host devices
        count = args.devices or (int(np.prod([int(n) for n in args.mesh.split(
            ":")[0].split("x")])) if args.mesh else None)
    with host_device_count(count):
        if args.mesh:
            return parse_mesh_spec(args.mesh, device=args.device)
        return make_fleet_mesh(args.devices, device=args.device)


def main(argv=None):
    """The CLI: returns ``run_control_loop``'s or ``run_drain_mode``'s
    result."""
    args = build_parser().parse_args(argv)
    control_mode = (args.policy == "ours"
                    or (args.autoscale or "none") != "none"
                    or args.cells > 1 or args.hierarchy)
    what = unported(args)
    if what:
        raise SystemExit(f"[serve] {what} is not yet ported")

    from repro_torch.configs import get_config
    from repro_torch.models.model import make_model

    mesh = serve_mesh(args)
    if mesh is not None:
        blocks = mesh.row_blocks(("fleet", "pod", "data", "expert"),
                                 "model")
        graphs = torch.device(args.device).type == "cuda" \
            and all(len(set(b)) == 1 for b in blocks)
        print(f"[serve] mesh: {mesh.shape} over {mesh.size} device(s); "
              f"decode steps {'as CUDA graphs' if graphs else 'eager'}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch).reduced()
    model = make_model(cfg, tp=1)
    params = model.init(seed=args.seed, dtype=torch.float32,
                        device=args.device)
    print(f"[serve] arch={cfg.name} policy={args.policy} "
          f"device={args.device} attn-backend={args.attn_backend}")
    if control_mode:
        if args.autoscale is None:
            args.autoscale = "gpso" if args.policy == "ours" else "none"
        return run_control_loop(args, cfg, model, params, mesh=mesh)
    if mesh is not None:
        print("[serve] note: --devices/--mesh apply to the control-loop "
              "mode only; drain mode steps replicas without a fleet slab")
    if args.policy == "wrr":
        args.policy = "fractions"
    return run_drain_mode(args, cfg, model, params)


if __name__ == "__main__":
    main()
