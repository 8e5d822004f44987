"""The system under test, composed as ``repro_torch.launch.serve.
run_control_loop`` composes it, and driven by open-loop arrivals in wall
time.

An ``ElasticClusterFrontend`` of ``ReplicaEngine``s (fleet batching,
fleet prefill, the async tick and decode graphs on) under a
``ControlPlane`` with the GCN+DDPG balancer and the GPSO autoscaler; one
``plane.step(n)`` a tick, ``n`` the requests that came due since the last
tick (``tick_seconds`` 1, so exactly ``n`` enter). The frontend's
``request_factory`` hands them out in due order; each token is stamped
with the wall clock of the tick end at which it appears in
``Request.output``.

Where the composition departs from ``run_control_loop``:

* replicas take their speed (0.7, 1.0, 1.4) and batch budget (max_batch
  / 2 or max_batch) from the sets of its factory, but as a balanced deal
  rather than independent draws: each run of nodes x max_replicas spawns
  is the same list (speeds 0.7, 1.0, 1.4, 1.0 in turn, the first half of
  the list at max_batch / 2 and the second at max_batch) in an order the
  seed permutes, so a fleet at its full size is the same fleet for every
  seed;
* requests come from the traffic file (open loop in wall time), not from
  its 2-11-token factory, and ``est_tokens`` is the traffic's mean output
  length, not 8;
* the plane gets its own defaults for ``forecast_scale`` and
  ``init_arrival`` in place of a tick trace's mean: with the last-value
  forecaster that both compose, the scale cancels, and the initial value
  fills only the first ``forecast_window`` ticks of the warm-up;
* no chaos, tiers, chunking, client pool, cells or hierarchy.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

SPEEDS_DEALT = (0.7, 1.0, 1.4, 1.0)


@dataclasses.dataclass
class Tracked:
    req: object            # the program's Request
    due: float             # perf_counter clock it was due at
    block: str
    stamps: list = dataclasses.field(default_factory=list)


def replica_mix(seed: int, max_batch: int, n: int):
    """Endless (speed, max_batch) pairs: each run of ``n`` is the balanced
    list (see the module docstring) permuted by the seed."""
    half = max(2, max_batch // 2)
    pairs = [(SPEEDS_DEALT[i % 4], half if i < n // 2 else max_batch)
             for i in range(n)]
    rng = np.random.default_rng([seed % 2**64, 7])
    while True:
        for i in rng.permutation(n):
            yield pairs[i]


class System:
    """The frontend and the plane over ``model``/``params``, with the
    harness's arrival queue in front and its token stamps behind."""

    def __init__(self, engine: dict, model, params, cache_dtype, device,
                 seed: int, est_tokens: float):
        from repro_torch.control import ControlPlane
        from repro_torch.core import balancer as bal
        from repro_torch.launch.serve import build_parser, cluster_config
        from repro_torch.serving.elastic import ElasticClusterFrontend
        from repro_torch.serving.engine import ReplicaEngine, Request
        from repro_torch.workload.trace import parse_tiers

        args = build_parser().parse_args([
            "--policy", engine["policy"], "--autoscale", engine["autoscale"],
            "--nodes", str(engine["nodes"]),
            "--replicas", str(engine["replicas"]),
            "--max-replicas", str(engine["max_replicas"]),
            "--provision-delay", str(engine["provision_delay"]),
            "--max-batch", str(engine["max_batch"]),
            "--max-seq", str(engine["max_seq"]), "--seed", str(seed),
            "--device", str(device)])
        ccfg = cluster_config(args)
        tiers = parse_tiers(args.tiers)
        mix = replica_mix(seed, args.max_batch,
                          args.nodes * args.max_replicas)
        self._handout: collections.deque = collections.deque()
        self.tracked: dict = {}           # rid -> Tracked
        self._live: list = []             # Tracked still generating

        def make_replica(rid: int):
            speed, mb = next(mix)
            return ReplicaEngine(model, params, max_batch=mb,
                                 max_seq=args.max_seq, rid=rid, speed=speed,
                                 cache_dtype=cache_dtype, tiers=tiers,
                                 attn_backend="pallas", device=device,
                                 decode_graph=True)

        def request_factory(rid: int, tick: int):
            a, due = self._handout.popleft()
            req = Request(rid, a.prompt, max_new_tokens=a.max_new_tokens)
            tr = Tracked(req, due, a.block)
            self.tracked[rid] = tr
            self._live.append(tr)
            return req

        self.fe = ElasticClusterFrontend(
            make_replica, args.nodes, initial_replicas=args.replicas,
            provisioning_delay=args.provision_delay,
            max_replicas_per_node=args.max_replicas,
            failure_rate=0.0, request_factory=request_factory, seed=seed,
            est_tokens=est_tokens, fleet_batch=True, fleet_prefill=True,
            async_tick=True, decode_block=1, tiers=tiers,
            preempt_notice=args.preempt_notice)
        rl = bal.RLBalancer(ccfg, 4 + ccfg.horizon, seed=seed, device=device)
        self.plane = ControlPlane(
            ccfg, self.fe, balancer="rl", scaler=args.autoscale,
            unit_capacity=args.max_batch / est_tokens, rl=rl, seed=seed,
            device=device)
        self.ticks = 0

    def step(self, due: list) -> dict:
        """One tick: ``due`` [(Arrival, due clock)] enter, the plane steps,
        new tokens are stamped. Returns the tick's metrics."""
        self._handout.extend(due)
        m = self.plane.step(float(len(due)))
        self.ticks += 1
        self.stamp(time.perf_counter())
        return m

    def stamp(self, now: float) -> None:
        keep = []
        for tr in self._live:
            out = tr.req.output
            while len(tr.stamps) < len(out):
                tr.stamps.append(now)
            if tr.req.finish_time is None:
                keep.append(tr)
        self._live = keep

    def counters(self) -> dict:
        """The program's counters, read afresh."""
        from repro_torch.kernels import ops

        fe, g = self.fe, self.fe.graph_stats()
        return {"t": time.perf_counter(), "ticks": self.ticks,
                "plane_host_s": sum(self.plane.host_s.values()),
                "sync_wait_s": fe.sync_wait_s(),
                "decode_dispatches": fe.decode_dispatches(),
                "decode_steps": fe.decode_steps(),
                "prefill_dispatches": fe.prefill_dispatches(),
                "syncs": fe.sync_count(),
                "captures": g.get("captures", 0) + g.get("recaptures", 0),
                "graphs": dict(g), "launches": dict(ops.LAUNCHES),
                "fetches": self.plane.fetches,
                "spawned": fe.replicas_spawned,
                "peak_slab_rows": fe.peak_slab_rows()}

    def waiting(self) -> int:
        """Requests not yet in a slot: the frontend's pending list and the
        node and replica queues (the backlog)."""
        fe = self.fe
        return len(fe.pending) + sum(
            len(n.queue) + sum(len(e.queue) for e in n.live + n.draining)
            for n in fe.nodes)

    def held(self) -> collections.Counter:
        """How many times each rid is held unfinished: in the frontend's
        pending list, a node queue, a replica queue or a replica slot."""
        c: collections.Counter = collections.Counter()
        fe = self.fe
        for r in fe.pending:
            c[r.rid] += 1
        for node in fe.nodes:
            for r in node.queue:
                c[r.rid] += 1
            for e in list(node.live) + list(node.draining):
                for r in e.queue:
                    c[r.rid] += 1
                for r in e.slots:
                    if r is not None:
                        c[r.rid] += 1
        return c


def free(system: "System") -> None:
    """Drop the program's state (slabs, caches, graphs) and give the card
    its memory back: a frontend and its fleet groups reference each other,
    so they go with a collection."""
    import gc

    for n in ("fe", "plane"):
        setattr(system, n, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
