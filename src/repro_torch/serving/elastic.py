"""``ElasticClusterFrontend``: a request-level ``ClusterBackend`` over real
model replicas (the port of ``repro.serving.elastic``).

N serving nodes, each holding a mutable group of ``ReplicaEngine``s, driven
by the ``ControlPlane``. Operational semantics are the reference's:

  * **cold start** — ``scale_to`` additions pass through a provisioning
    pipeline and only serve after ``provisioning_delay`` ticks;
  * **graceful drain** — removals stop admitting, hand queued work back to
    the node, finish their in-flight slots, then retire;
  * **failure injection** — a failed replica loses its generation progress;
    every in-flight + queued request is reset and re-queued in arrival
    order (``fail_replica`` for deterministic tests, ``failure_rate`` for
    Bernoulli-per-tick injection);
  * **heterogeneity** — the replica factory may vary ``max_batch`` and
    ``speed`` per replica; speed>1 replicas run several decode sub-steps per
    tick via a credit accumulator, speed<1 skip ticks.

**Fleet-batched ticks** (default): live + draining replicas that share a
``fleet_key`` are stacked into ``FleetGroup``s across node boundaries, so
one tick advances every replica of a group with ONE decode dispatch (one
``flash_decode`` launch per layer over the group's flat slab) and one
prefill dispatch per distinct bucket shape. Heterogeneous speeds run as
sub-step *rounds*; a round where only a subset of a group steps leaves the
other rows' cache untouched. ``fleet_batch=False`` recovers the
per-replica ``step()`` loop and ``fleet_prefill=False`` per-replica
admission (the parity oracles).

**Overlapped async ticks** (default with fleet batching): fleet results
stay on the device as pending results and the deferred host bookkeeping
applies at ONE reconcile sync at the next tick's start, so the host half
of tick t (metrics, queues, the control plane's forecast -> balance ->
scale) overlaps the device computing tick t's decode. Token streams and
finish ticks are bit-identical to ``async_tick=False`` (the eager oracle);
only host-side observation lags one tick. On a card each group's decode
dispatch replays a captured CUDA graph (``serving.graphs``).
``decode_block=K`` additionally fuses K decode micro-steps into one
dispatch and one sync on ticks with no pending admissions, dropping
syncs a tick to 1/K in the saturated-decode regime -- at the cost that a
slot retiring mid-block re-admits only at the block-end reconcile
(admission lag <= K - 1 ticks under a full slab; see the engine
docstring).

**SLO tiers, the exactly-once ``RequestLedger``, deadlines, scripted chaos
(``ChaosSchedule``: fail / preempt / recover / slow), spot preemption and
capacity leases** are the reference's, unchanged; see
``repro.serving.elastic`` for the full contract. ``metrics()`` carries the
reference's keys, plus the async tick's sync accounting (``reconciles``,
``replica_syncs``, ``last_round_dispatches``, ``in_flight_groups``) that
``async_tick_violations`` holds to its contract.

**Fleet-mesh sharding.** Pass ``mesh=`` (a ``launch.mesh.Mesh`` with a
``fleet`` axis, e.g. ``launch.mesh.make_fleet_mesh``) and every fleet group
splits its slab rows over the mesh's ``fleet`` x data-like row blocks,
and over a ``model`` axis each replica's heads: one logical dispatch and
one sync a tick as before, each run once a block on its devices, with the
same streams, clocks and counts as unsharded (``FleetGroup``'s shard
contract). On the CPU the devices are virtual
(``launch.mesh.set_host_device_count``).
"""
from __future__ import annotations

import re
from collections import deque
from typing import Callable, Optional

import numpy as np

from repro_torch import telemetry
from repro_torch.serving.engine import (FleetGroup, ReplicaEngine, Request,
                                        TieredQueue, normalize_fractions)
from repro_torch.workload.trace import DEFAULT_TIERS, TierSet

_SERVICE_RATE_WARMUP = 8       # measured-rate ticks before the EMA is trusted
_SERVICE_RATE_ALPHA = 0.1


def _requeue_merged(queue, reqs) -> None:
    """Merge re-queued work back into ``queue`` (deque or TieredQueue)
    preserving *global* arrival order (rid tiebreak). Drain hand-backs and
    failure re-queues must not append or prepend blindly: either loses the
    original arrival ordering the tiered starvation accounting (and plain
    FIFO fairness) relies on."""
    merged = sorted(list(queue) + list(reqs),
                    key=lambda r: (r.arrival, r.rid))
    queue.clear()
    for r in merged:
        queue.append(r)


def async_tick_violations(per_tick: list) -> list:
    """The async fleet tick's sync contract, checked over a run's per-tick
    metrics (in order, from the first tick): every blocking sync consumes
    the results of one fleet dispatch -- a group's decode with the
    admission of the same round -- so a tick pays at most the dispatches
    carried in from the previous tick plus its own, less those it leaves in
    flight; and a tick with no churn flush leaves exactly its last round's
    dispatches in flight (it never waits for them). Returns one message per
    broken tick; empty when the contract held."""
    bad, carried = [], 0
    for t, m in enumerate(per_tick):
        # a replica's own syncs (an exact-length admit's eager prefill
        # fetch, the reference's single-admit path) consume no dispatch
        syncs = m["syncs"] - m.get("replica_syncs", 0)
        left = m["in_flight_groups"]
        if syncs + left > carried + m["decode_dispatches"]:
            bad.append(f"tick {t}: {syncs} syncs + {left} in flight > "
                       f"{carried} carried + {m['decode_dispatches']} "
                       "decode dispatches")
        if syncs == m["reconciles"] and left != m["last_round_dispatches"]:
            bad.append(f"tick {t}: {left} groups in flight, last round "
                       f"dispatched {m['last_round_dispatches']}")
        carried = left
    return bad


_TERMINAL_STATES = ("finished", "timed_out", "abandoned", "rejected", "shed")
_RETRYABLE_STATES = ("timed_out", "rejected", "shed")


class RequestLedger:
    """Exactly-once request accounting for the frontend.

    Every rid is a state machine: ``live`` while an attempt is in the
    system, then exactly one of ``finished`` / ``timed_out`` /
    ``abandoned`` / ``rejected`` / ``shed``. Retries (same rid, fresh
    ``Request`` object) are accepted only from the retryable terminal states
    (``timed_out``, ``rejected``, ``shed``); a re-submit racing a live attempt or a
    completed/abandoned rid is *suppressed* — that single rule guarantees
    at most one attempt per rid is ever in flight, so no queue surgery is
    needed for duplicate suppression. A completion that arrives for an
    ``abandoned`` rid counts as ``wasted`` work (the client left; the
    tokens are not goodput); a completion for any other terminal state
    increments ``double_served``, the self-check that must stay 0.
    Per-tier rows count terminal *events* (a rid that times out twice and
    then finishes contributes 2 timed_out + 1 finished events)."""

    def __init__(self):
        self.state: dict = {}       # rid -> state
        self.tier: dict = {}        # rid -> tier name (at first register)
        self.submitted = 0          # distinct rids ever registered
        self.retries = 0            # accepted re-submits
        self.duplicates = 0         # suppressed re-submits
        self.wasted = 0             # completions of abandoned rids
        self.double_served = 0      # completions in a served state: MUST be 0
        self._per_tier: dict = {}

    def tier_row(self, tier: str) -> dict:
        return self._per_tier.setdefault(
            tier, {"finished": 0, "timed_out": 0, "abandoned": 0,
                   "rejected": 0, "shed": 0, "retries": 0})

    @property
    def per_tier(self) -> dict:
        return self._per_tier

    def register(self, req: Request) -> bool:
        """Admit ``req`` into the ledger. True = accept (fresh rid or a
        legal retry), False = suppress (duplicate of a live / finished /
        abandoned rid — the caller must NOT enqueue it)."""
        st = self.state.get(req.rid)
        if st is None:
            self.state[req.rid] = "live"
            self.tier[req.rid] = req.tier
            self.submitted += 1
            return True
        if st in _RETRYABLE_STATES:
            self.state[req.rid] = "live"
            self.retries += 1
            self.tier_row(self.tier[req.rid])["retries"] += 1
            return True
        self.duplicates += 1
        return False

    def reject(self, req: Request) -> None:
        """Admission control turned the (just-registered) attempt away."""
        self.state[req.rid] = "rejected"
        self.tier_row(self.tier[req.rid])["rejected"] += 1

    def shed(self, req: Request) -> None:
        """Overload shedding turned the attempt away: under total overload
        the router degrades gracefully by refusing lowest-tier traffic at
        admission instead of letting every queue grow without bound. An
        explicit terminal state — never silent loss — and retryable, so a
        backing-off client may come back once pressure clears."""
        self.state[req.rid] = "shed"
        self.tier_row(self.tier[req.rid])["shed"] += 1

    def abandon(self, rid: int) -> bool:
        """The client gave up on ``rid``. Legal from ``live`` (the attempt
        still in the system will complete as wasted work), ``timed_out``
        and ``rejected``; a no-op after ``finished`` (the client already
        got the answer)."""
        st = self.state.get(rid)
        if st in ("live",) + _RETRYABLE_STATES:
            self.state[rid] = "abandoned"
            self.tier_row(self.tier[rid])["abandoned"] += 1
            return True
        return False

    def resolve(self, req: Request) -> str:
        """Classify a completion coming out of the engines: ``finished``
        if it met its deadline, ``timed_out`` if it expired (deadline
        retire or queue cull), ``abandoned``+wasted if the client already
        left. Unknown rids (engine-level callers that bypassed ``submit``)
        are registered on the spot so the ledger still balances."""
        st = self.state.get(req.rid)
        if st is None:
            self.submitted += 1
            self.tier[req.rid] = req.tier
            st = "live"
        if st == "abandoned":
            self.wasted += 1
            return "abandoned"
        if st != "live":
            self.double_served += 1      # exactly-once violation
            return st
        end = "timed_out" if req.expired else "finished"
        self.state[req.rid] = end
        self.tier_row(self.tier[req.rid])[end] += 1
        return end

    def balance(self) -> dict:
        """Final-state histogram over all rids (+ the event counters)."""
        by = {k: 0 for k in ("live",) + _TERMINAL_STATES}
        for st in self.state.values():
            by[st] += 1
        by.update(submitted=self.submitted, retries=self.retries,
                  duplicates=self.duplicates, wasted=self.wasted,
                  double_served=self.double_served)
        return by

    def balanced(self) -> bool:
        """Conservation check: every submitted rid is in exactly one
        terminal state, and nothing was ever served twice."""
        b = self.balance()
        return (b["live"] == 0 and self.double_served == 0
                and sum(b[k] for k in _TERMINAL_STATES) == len(self.state))


class ChaosSchedule:
    """Deterministic scripted chaos: fail / preempt / recover / slow events
    keyed by tick, plus cell-level events for the multi-cell routing plane
    (``control.cells.MultiCellBackend``) and plane-level events for the
    two-level control hierarchy (``control.hierarchy``). Spec syntax
    (comma-separated)::

        preempt@12:n0:k3   # tick 12: preemption notice on node 0, K=3
        preempt@20:n1      # frontend-default notice
        fail@8:n1:r0       # tick 8: kill node 1's live replica 0
        fail@9:n0          # replica 0 by default
        recover@40:n0      # tick 40: bring node 0 back from 'down'
        slow@6:n1:x4       # tick 6: node 1's replicas run at 1/4 speed
        slow@18:n1:x1      # x1 clears the straggler (full speed again)
        cell_down@15:c0    # tick 15: blackout cell 0 (evacuate + re-route)
        cell_up@30:c0      # tick 30: restore cell 0 (provisioning applies)
        partition@10:c1:k6 # tick 10: cell 1's metrics feed stale for 6 ticks
        heal@14:c1         # end cell 1's partition early
        plane_down@12:k8   # tick 12: global control plane crashes, 8 ticks
        plane_down@12      # ...or until an explicit plane_up
        plane_up@20        # tick 20: global plane restarts (from checkpoint)

    Node-kind events are consumed by the backends' own ``_advance_chaos``
    (elastic frontend / fluid sim); cell- and plane-kind events are
    consumed by the routing plane. ``pop`` is non-destructive, so one
    schedule can feed both consumers — each filters to the kinds it owns.
    Plane events carry no target index (the global plane is a singleton);
    they are stored with index -1. Events validate at parse time (syntax)
    and again when applied (indices and liveness)."""

    NODE_KINDS = ("preempt", "fail", "recover", "slow")
    CELL_KINDS = ("cell_down", "cell_up", "partition", "heal")
    PLANE_KINDS = ("plane_down", "plane_up")

    _EVENT = re.compile(
        r"^(?P<kind>preempt|fail|recover|slow|cell_down|cell_up|partition"
        r"|heal)"
        r"@(?P<tick>\d+):(?P<scope>[nc])(?P<idx>\d+)"
        r"(?::(?P<argkind>[krx])(?P<arg>\d+))?$")
    _PLANE = re.compile(
        r"^(?P<kind>plane_down|plane_up)@(?P<tick>\d+)(?::k(?P<arg>\d+))?$")

    def __init__(self):
        self.events: dict = {}       # tick -> [(kind, node_or_cell, arg|None)]

    def add(self, tick: int, kind: str, node: int = -1,
            arg: Optional[int] = None):
        if kind not in self.NODE_KINDS + self.CELL_KINDS + self.PLANE_KINDS:
            raise ValueError(f"unknown chaos event kind {kind!r}")
        self.events.setdefault(int(tick), []).append((kind, int(node), arg))
        return self

    @classmethod
    def parse(cls, spec: str) -> "ChaosSchedule":
        sched = cls()
        for part in filter(None, (p.strip() for p in spec.split(","))):
            p = cls._PLANE.match(part)
            if p is not None:
                if p["kind"] == "plane_up" and p["arg"] is not None:
                    raise ValueError(
                        f"{part!r}: ':k' only applies to plane_down")
                sched.add(int(p["tick"]), p["kind"], -1,
                          int(p["arg"]) if p["arg"] is not None else None)
                continue
            m = cls._EVENT.match(part)
            if m is None:
                raise ValueError(
                    f"bad chaos event {part!r} — expected "
                    "'preempt@T:nN[:kK]', 'fail@T:nN[:rR]', 'recover@T:nN', "
                    "'slow@T:nN:xF', 'cell_down@T:cC', 'cell_up@T:cC', "
                    "'partition@T:cC[:kK]', 'heal@T:cC', "
                    "'plane_down@T[:kK]' or 'plane_up@T'")
            kind, scope, argkind = m["kind"], m["scope"], m["argkind"]
            want = "c" if kind in cls.CELL_KINDS else "n"
            if scope != want:
                raise ValueError(
                    f"{part!r}: {kind} targets a "
                    f"{'cell (cC)' if want == 'c' else 'node (nN)'}")
            if argkind == "k" and kind not in ("preempt", "partition"):
                raise ValueError(
                    f"{part!r}: ':k' only applies to preempt/partition")
            if argkind == "r" and kind != "fail":
                raise ValueError(f"{part!r}: ':r' only applies to fail")
            if argkind == "x" and kind != "slow":
                raise ValueError(f"{part!r}: ':x' only applies to slow")
            if kind == "slow" and argkind != "x":
                raise ValueError(
                    f"{part!r}: slow needs a ':xF' factor (x1 clears)")
            sched.add(int(m["tick"]), kind, int(m["idx"]),
                      int(m["arg"]) if m["arg"] is not None else None)
        return sched

    def pop(self, tick: int) -> list:
        return self.events.get(tick, [])


class _Node:
    __slots__ = ("live", "draining", "spawning", "queue", "credit",
                 "preempt_left", "down", "slow")

    def __init__(self, tiers: TierSet):
        self.live: list = []        # serving ReplicaEngines
        self.draining: list = []    # finishing in-flight work, no admits
        self.spawning: list = []    # remaining cold-start ticks per add
        # node-level request queue: tier-aware (the deep backlog lives here
        # — replica queues only buffer up to max_batch), single-tier == FIFO
        self.queue: TieredQueue = TieredQueue(tiers)
        self.credit: dict = {}      # engine id -> fractional step credit
        self.preempt_left = -1      # ticks of preemption notice left; -1=none
        self.down = False           # preempted away; needs recover_node
        self.slow = 1.0             # straggler speed factor (slow@t:nI:xF)

    def unfinished(self) -> int:
        return len(self.queue) + sum(e.load for e in self.live) + \
            sum(e.load for e in self.draining)


class ElasticClusterFrontend:
    """Node-structured elastic serving cluster (see module docstring)."""

    def __init__(self, make_replica: Callable[[int], ReplicaEngine],
                 num_nodes: int, *, initial_replicas: int = 1,
                 provisioning_delay: int = 0,
                 max_replicas_per_node: int = 8,
                 failure_rate: float = 0.0,
                 request_factory: Optional[Callable[[int, int], Request]] = None,
                 tick_seconds: float = 1.0, seed: int = 0,
                 est_tokens: float = 8.0, fleet_batch: bool = True,
                 fleet_prefill: bool = True, async_tick: bool = True,
                 decode_block: int = 1,
                 tiers: Optional[TierSet] = None, mesh=None,
                 preempt_notice: int = 0,
                 chaos: Optional[ChaosSchedule] = None,
                 max_queue: Optional[int] = None,
                 ledger: Optional[RequestLedger] = None):
        self.make_replica = make_replica
        # a serving mesh with a 'fleet' axis: every fleet group splits its
        # slab rows over the mesh's shards (FleetGroup's shard contract)
        self.mesh = mesh if fleet_batch else None
        self.num_nodes = num_nodes
        self.tiers = tiers or DEFAULT_TIERS
        self.provisioning_delay = int(provisioning_delay)
        self.max_replicas_per_node = max_replicas_per_node
        self.failure_rate = failure_rate
        self.preempt_notice = int(preempt_notice)  # default K for preemptions
        self.chaos = chaos                # scripted fail/preempt/recover
        self.max_queue = max_queue        # admission cap -> 'rejected' rids
        self.request_factory = request_factory
        self.tick_seconds = tick_seconds
        self.fleet_batch = fleet_batch
        self.fleet_prefill = fleet_prefill and fleet_batch
        # the async tick needs the fleet dispatch paths end to end: with
        # either oracle mode (per-replica decode or per-replica admission)
        # the tick falls back to eager, blocking syncs
        self.async_tick = bool(async_tick) and self.fleet_prefill
        self.decode_block = max(1, int(decode_block)) if self.async_tick \
            else 1
        self.rng = np.random.default_rng(seed)
        self.nodes = [_Node(self.tiers) for _ in range(num_nodes)]
        self._rid = 0                # engine ids (replicas ever created)
        self._req_id = 0             # auto-generated request ids
        self._acc = 0.0              # fractional-arrival accumulator
        self.t = 0
        self.pending: deque = deque()
        self.finished: list = []
        self.failed_replicas = 0
        self.preempted_replicas = 0   # hard-dropped at notice expiry
        self.preempted_nodes = 0
        self.replica_ticks = 0
        # ledger may be shared: a multi-cell routing plane passes one global
        # RequestLedger to every cell so exactly-once holds ACROSS cells
        # (an evacuated request re-routed to a sibling cell resolves in the
        # same state machine — double_served stays 0 federation-wide)
        self.ledger = RequestLedger() if ledger is None else ledger
        self._blackout_profile: Optional[list] = None
        self._lease: Optional[tuple] = None   # (min, max) total replicas
        self._tick_goodput = 0        # this tick's in-deadline completions
        self._tick_timed_out = 0      # this tick's expired completions
        self._fractions = np.full(num_nodes, 1.0 / num_nodes, np.float32)
        self._m: dict = {}
        self._est_tokens = float(est_tokens)  # EMA of tokens per request
        self._resp_est = 0.0
        self._shape_sets: dict = {}  # id -> prefill-shape set (shared)
        self._fleets: dict = {}      # fleet_key -> FleetGroup (spans nodes)
        self._tick_dispatches = 0    # decode dispatches issued this tick
        self._tick_prefill_dispatches = 0  # admission dispatches this tick
        self._tick_syncs = 0         # blocking host syncs this tick
        self._tick_replica_syncs = 0  # of which the replicas' own
        self._tick_reconciles = 0    # of which at the reconcile points
        self._tick_last_round = 0    # decode dispatches of the last round
        self._tick_sync_wait = 0.0   # seconds blocked on device this tick
        self._retired_dispatches = 0  # dispatch counts of evicted groups
        self._retired_steps = 0      # decode micro-steps of evicted groups
        self._retired_shard_prefills = 0  # their fleet prefills, a shard each
        self._retired_shard_steps = 0  # their micro-steps, a shard each
        self._retired_graphs: dict = {}  # graph counts of evicted groups
        self._retired_group_prefills = 0  # prefill dispatches: evicted groups
        self._retired_replica_prefills = 0  # and of retired engines
        self._retired_group_syncs = 0    # sync counts of evicted groups
        self._retired_replica_syncs = 0  # and of retired engines
        self._retired_sync_wait = 0.0
        self._retired_peak_rows = 0   # largest slab of an evicted group
        self._async_stash: list = []  # finishes flushed by mid-tick churn
        self._srv_rate: Optional[float] = None  # per-replica req/tick EMA
        self._srv_obs = 0            # ticks the EMA has been fed
        for node in self.nodes:
            for _ in range(initial_replicas):
                self._go_live(node)

    # ----------------------------------------------------------- plumbing
    def _spawn(self) -> ReplicaEngine:
        eng = self.make_replica(self._rid)
        self._rid += 1
        # remember the (shared) prefill-shape sets so the counts survive
        # replica retirement/failure
        self._shape_sets[id(eng._shapes)] = eng._shapes
        return eng

    def _go_live(self, node: _Node) -> ReplicaEngine:
        """Spawn a replica onto ``node`` and enroll it in its fleet group
        (groups span nodes: the fleet axis is per model-shape, not per
        node)."""
        eng = self._spawn()
        node.live.append(eng)
        if self.fleet_batch:
            g = self._fleets.get(eng.fleet_key)
            if g is None:
                g = self._fleets[eng.fleet_key] = FleetGroup(
                    eng.model, eng.params, max_batch=eng.max_batch,
                    max_seq=eng.max_seq, cache_dtype=eng.cache_dtype,
                    async_mode=self.async_tick,
                    decode_block=self.decode_block,
                    attn_backend=eng.attn_backend, mesh=self.mesh,
                    device=eng.device)
            g.add(eng)
        return eng

    def _leave_fleet(self, eng: ReplicaEngine, restore: bool):
        g = eng._fleet
        if g is None:
            return
        g.remove(eng, restore=restore)  # flushes the group's pending futures
        if not g.members:
            # evict the empty group so its high-water-mark slab doesn't pin
            # device memory forever (a re-spawn re-allocates from zeros)
            self._async_stash.extend(g.reconcile(force=True))
            self._retired_dispatches += g.dispatches
            self._retired_steps += g.decode_steps
            self._retired_shard_prefills += g.shard_prefills
            self._retired_shard_steps += g.shard_steps
            for k, n in g.graph_stats().items():
                self._retired_graphs[k] = self._retired_graphs.get(k, 0) + n
            self._retired_group_prefills += g.prefill_dispatches
            self._retired_group_syncs += g.syncs
            self._retired_sync_wait += g.sync_wait
            self._retired_peak_rows = max(self._retired_peak_rows,
                                          g.peak_rows)
            self._fleets = {k: v for k, v in self._fleets.items()
                            if v is not g}

    def prefill_retraces(self) -> int:
        """Distinct prefill shapes across every replica ever spawned (the
        analogue of the reference's prefill compile count; shape sets are
        shared per model config, so retired replicas still count)."""
        return sum(len(s) for s in self._shape_sets.values())

    def decode_dispatches(self) -> int:
        """Total fleet decode dispatches issued (fleet mode),
        including groups since evicted."""
        return self._retired_dispatches + \
            sum(g.dispatches for g in self._fleets.values())

    def decode_steps(self) -> int:
        """Total fleet decode micro-steps run (a block of K counts K),
        including groups since evicted."""
        return self._retired_steps + \
            sum(g.decode_steps for g in self._fleets.values())

    def shard_dispatches(self) -> tuple:
        """``prefill_dispatches()`` and ``decode_steps()`` with each fleet
        dispatch counted once a shard that ran it under a fleet mesh
        (equal to them unsharded): a run's kernel launches follow from
        these."""
        live = self._fleets.values()
        return (self.replica_prefill_dispatches()
                + self._retired_shard_prefills
                + sum(g.shard_prefills for g in live),
                self._retired_shard_steps
                + sum(g.shard_steps for g in live))

    def graph_stats(self) -> dict:
        """The fleet groups' decode-graph counts (captures, recaptures
        after slab growth, replays), evicted groups included."""
        out = dict(self._retired_graphs)
        for g in self._fleets.values():
            for k, n in g.graph_stats().items():
                out[k] = out.get(k, 0) + n
        return out

    def prefill_dispatches(self) -> int:
        """Total admission dispatches issued: per-engine bucketed /
        exact-length / chunk calls plus the fleet-batched prefill and chunk
        dispatches, including retired engines and evicted groups."""
        return self.replica_prefill_dispatches() + \
            self._retired_group_prefills + \
            sum(g.prefill_dispatches for g in self._fleets.values())

    def replica_prefill_dispatches(self) -> int:
        """The dispatches of ``prefill_dispatches`` that replicas issued
        themselves (not their fleet group), retired engines included."""
        return self._retired_replica_prefills + sum(
            e.prefill_dispatches for n in self.nodes
            for e in n.live + n.draining)

    def sync_count(self) -> int:
        """Total blocking host syncs performed (group reconciles + eager
        fetches), including retired engines and evicted groups — the async
        tick's ``syncs`` currency, mirroring ``decode_dispatches``."""
        return self.replica_sync_count() + self._retired_group_syncs + \
            sum(g.syncs for g in self._fleets.values())

    def replica_sync_count(self) -> int:
        """The syncs of ``sync_count`` that replicas took themselves (not
        their fleet group): under the async fleet tick, the exact-length
        admits' eager prefill fetches."""
        return self._retired_replica_syncs + sum(
            e.syncs for n in self.nodes for e in n.live + n.draining)

    def sync_wait_s(self) -> float:
        """Total wall seconds the host spent *blocked* on device results —
        the device half of the tick-wall breakdown (host half = tick wall
        minus this)."""
        live = sum(e.sync_wait
                   for n in self.nodes for e in n.live + n.draining)
        return self._retired_sync_wait + live + \
            sum(g.sync_wait for g in self._fleets.values())

    def prefill_shapes(self) -> set:
        """The distinct prefill shapes behind ``prefill_retraces``."""
        return set().union(*self._shape_sets.values())

    def peak_slab_rows(self) -> int:
        """The most slab rows (capacity x max_batch) any fleet group ever
        allocated, evicted groups included."""
        return max([self._retired_peak_rows]
                   + [g.peak_rows for g in self._fleets.values()])

    @telemetry.spanned("frontend.reconcile")
    def _reconcile_all(self) -> list:
        """The per-tick reconcile point: flush every fleet group's pending
        device futures (one blocking sync per group) and collect the newly
        finished requests, plus any stashed by mid-tick churn flushes."""
        out, self._async_stash = self._async_stash, []
        before = self.sync_count()
        for g in list(self._fleets.values()):
            out.extend(g.reconcile())
        self._tick_reconciles += self.sync_count() - before
        return out

    @property
    def replicas(self) -> list:
        """All live replicas (diagnostics)."""
        return [e for n in self.nodes for e in n.live]

    @property
    def replicas_spawned(self) -> int:
        """Replicas ever created (incl. failed/retired ones)."""
        return self._rid

    def alloc_rid(self) -> int:
        """Hand out a fresh request id (shared counter with the open-loop
        arrival generator, so closed-loop clients never collide)."""
        rid = self._req_id
        self._req_id += 1
        return rid

    def _outstanding(self) -> int:
        return len(self.pending) + sum(n.unfinished() for n in self.nodes)

    def submit(self, req: Request) -> bool:
        """Submit one attempt. Returns False when the attempt was NOT
        enqueued: either suppressed as a duplicate (an attempt for this rid
        is live, or the rid already finished / was abandoned — exactly-once
        guarantee) or rejected by the ``max_queue`` admission cap. Retries
        of timed-out / rejected rids are accepted; each retry must be a
        FRESH ``Request`` object (never re-submit a served-on object)."""
        if req.arrival == 0.0:
            req.arrival = float(self.t)
        if not self.ledger.register(req):
            return False
        if self.max_queue is not None and self._outstanding() >= self.max_queue:
            self.ledger.reject(req)
            return False
        self.pending.append(req)
        return True

    def abandon(self, rid: int) -> bool:
        """Client-side abandonment: the rid's terminal state becomes
        ``abandoned``; a live attempt keeps running and its completion
        counts as wasted work (not goodput). Queued attempts with a
        deadline are culled by the expiry sweep; abandonment never reaches
        into queues, so streams are unaffected."""
        return self.ledger.abandon(rid)

    # ------------------------------------------------- ClusterBackend API
    def up_mask(self) -> np.ndarray:
        return np.asarray([1.0 if n.live else 0.0 for n in self.nodes],
                          np.float32)

    def queue_depths(self) -> np.ndarray:
        return np.asarray([n.unfinished() for n in self.nodes], np.float32)

    def capacity(self) -> np.ndarray:
        """Decode slots/tick per node (live replicas only, scaled by the
        node's straggler factor)."""
        return np.asarray(
            [sum(e.max_batch * e.speed for e in n.live) * n.slow
             for n in self.nodes],
            np.float32)

    def request_capacity(self) -> np.ndarray:
        """Requests/tick per node at the current mean output length."""
        return self.capacity() / max(self._est_tokens, 1.0)

    def in_flight(self) -> np.ndarray:
        return np.asarray(
            [len(n.live) + len(n.spawning) for n in self.nodes], np.int32)

    @property
    def node_speed(self) -> np.ndarray:
        return np.asarray(
            [(np.mean([e.speed for e in n.live]) if n.live else 1.0) * n.slow
             for n in self.nodes], np.float32)

    def observe(self, forecast: np.ndarray) -> np.ndarray:
        """Same Eq.1-3 feature layout as ``ClusterSim.observation``."""
        q = self.queue_depths()
        cap = self.request_capacity()
        total_cap = max(cap.sum(), 1e-9)
        load = q / max(q.sum(), 1.0)
        util_proxy = np.minimum(q / np.maximum(cap, 1e-9), 4.0) / 4.0
        capn = cap / total_cap
        up = self.up_mask()
        f = np.broadcast_to(forecast[None, :],
                            (self.num_nodes, forecast.shape[0]))
        obs = np.concatenate([load[:, None], util_proxy[:, None],
                              capn[:, None], up[:, None], f], axis=1)
        return obs.astype(np.float32)

    def route(self, fractions: np.ndarray) -> None:
        self._fractions = np.asarray(fractions, np.float64)

    def metrics(self) -> dict:
        return self._m

    def set_lease(self, min_replicas: int, max_replicas: int) -> None:
        """Bound every future ``scale_to`` to a capacity lease: the cell's
        TOTAL in-flight replica count (live + spawning, across nodes) is
        clamped into ``[min_replicas, max_replicas]``. Granted by the
        hierarchy's ``GlobalPlanner`` (see ``control/hierarchy.py``); the
        clamp holds even when the global plane itself issues the target,
        so a restored plane replaying a stale plan cannot overshoot the
        lease. ``set_lease(None)``-style clearing is spelled
        ``clear_lease()``."""
        lo, hi = int(min_replicas), int(max_replicas)
        if lo < 0 or hi < lo:
            raise ValueError(f"bad lease [{min_replicas}, {max_replicas}]")
        self._lease = (lo, hi)

    def clear_lease(self) -> None:
        self._lease = None

    @property
    def lease(self):
        return self._lease

    def _apply_lease(self, desired: dict) -> dict:
        """Clamp the requested per-node targets so the cell total lands in
        the lease. Trims largest-target-first, raises smallest-first
        (deterministic tie-break on node index); replicas held by doomed
        nodes (skipped by ``scale_to``) count against the lease."""
        if self._lease is None or not desired:
            return desired
        lo, hi = self._lease
        held = sum(len(n.live) + len(n.spawning)
                   for i, n in enumerate(self.nodes) if i not in desired)
        total = sum(desired.values()) + held
        while total > hi:
            i = max(desired, key=lambda j: (desired[j], -j))
            if desired[i] == 0:
                break
            desired[i] -= 1
            total -= 1
        while total < lo:
            room = [j for j in desired
                    if desired[j] < self.max_replicas_per_node]
            if not room:
                break
            i = min(room, key=lambda j: (desired[j], j))
            desired[i] += 1
            total += 1
        return desired

    def scale_to(self, target: np.ndarray) -> None:
        """Adds go through cold-start provisioning; removals drain first.
        When a capacity lease is set (``set_lease``) the cell total is
        clamped into it before any node-level action."""
        target = np.asarray(target)
        desired = {}
        for i, node in enumerate(self.nodes):
            if node.down or node.preempt_left >= 0:
                continue              # never spawn onto a doomed/dead node
            desired[i] = int(np.clip(target[i], 0,
                                     self.max_replicas_per_node))
        desired = self._apply_lease(desired)
        for i, tgt in desired.items():
            node = self.nodes[i]
            in_flight = len(node.live) + len(node.spawning)
            if tgt > in_flight:
                node.spawning.extend(
                    [self.provisioning_delay] * (tgt - in_flight))
            elif tgt < in_flight:
                rem = in_flight - tgt
                while rem and node.spawning:   # cancel pending spawns first
                    node.spawning.remove(max(node.spawning))
                    rem -= 1
                # drain live replicas, least-loaded first
                for eng in sorted(node.live, key=lambda e: e.load)[:rem]:
                    self._drain(node, eng)

    def _drain(self, node: _Node, eng: ReplicaEngine):
        eng.draining = True
        handed = list(eng.queue)         # un-admitted work goes back, merged
        eng.queue.clear()                # in arrival order (not appended —
        _requeue_merged(node.queue, handed)     # see _requeue_merged)
        node.live.remove(eng)
        node.draining.append(eng)

    # ------------------------------------------------------------ failures
    def _check_node(self, node_idx: int) -> _Node:
        """Shared validation for the chaos entry points: a clear
        ``ValueError`` instead of a raw ``IndexError`` (negative indices
        would otherwise silently wrap)."""
        if not isinstance(node_idx, (int, np.integer)):
            raise ValueError(
                f"node index must be an int, got {type(node_idx).__name__}")
        if not 0 <= node_idx < self.num_nodes:
            raise ValueError(
                f"node index {node_idx} out of range for "
                f"{self.num_nodes} nodes")
        return self.nodes[int(node_idx)]

    def fail_replica(self, node_idx: int, replica_idx: int = 0):
        """Deterministic failure injection (tests / chaos drills)."""
        node = self._check_node(node_idx)
        if node.down:
            raise ValueError(
                f"node n{node_idx} is down (preempted); nothing to fail")
        if not node.live:
            raise ValueError(f"node n{node_idx} has no live replicas")
        if not 0 <= replica_idx < len(node.live):
            raise ValueError(
                f"replica index {replica_idx} out of range: node "
                f"n{node_idx} has {len(node.live)} live replicas")
        self._fail(node, node.live[replica_idx])

    def preempt_node(self, node_idx: int, notice: Optional[int] = None):
        """Spot-preemption notice on a whole node: every live replica
        drains under the deadline, pending spawns are cancelled, no new
        work routes there (``up_mask`` drops to 0 once nothing is live).
        After ``notice`` ticks (default the frontend's ``preempt_notice``)
        whatever is still in flight is hard-dropped: evacuated, re-queued
        in arrival order, and the node goes ``down`` until
        ``recover_node``. ``notice<=0`` preempts immediately."""
        node = self._check_node(node_idx)
        if node.down:
            raise ValueError(f"node n{node_idx} is already down")
        if node.preempt_left >= 0:
            raise ValueError(
                f"node n{node_idx} already has a preemption notice "
                f"({node.preempt_left} ticks left)")
        left = self.preempt_notice if notice is None else int(notice)
        node.spawning = []            # a doomed node never finishes a spawn
        for eng in list(node.live):   # drain-under-deadline
            self._drain(node, eng)
        if left <= 0:
            self._preempt_finalize(node)
        else:
            node.preempt_left = left

    def recover_node(self, node_idx: int):
        """Bring a preempted node back into the schedulable pool (empty —
        capacity returns when the autoscaler targets it again)."""
        node = self._check_node(node_idx)
        if not node.down:
            raise ValueError(f"node n{node_idx} is not down")
        node.down = False

    def slow_node(self, node_idx: int, factor: int):
        """Deterministic straggler injection (``slow@t:nI:xF``): every
        replica on the node runs at 1/``factor`` speed — capacity,
        ``node_speed`` and per-tick step credit all scale down, so the
        router shifts work away and the autoscaler sees the lost
        throughput. ``factor == 1`` clears the straggler. Persists across
        replica churn (the factor lives on the node, not the engines)."""
        node = self._check_node(node_idx)
        if factor is None or not isinstance(factor, (int, np.integer)):
            raise ValueError(
                f"slow factor must be an int >= 1, got {factor!r}")
        if factor < 1:
            raise ValueError(f"slow factor must be >= 1, got {factor}")
        if node.down:
            raise ValueError(
                f"node n{node_idx} is down (preempted); nothing to slow")
        node.slow = 1.0 / int(factor)

    def blackout(self) -> list:
        """Cell blackout (the multi-cell routing plane's evacuation hook):
        hard-drop the ENTIRE cell now. Every node — healthy, under notice,
        or mid-drain — goes through the same ledger-safe failure path as a
        notice expiry (pending device futures flush BEFORE progress resets,
        in-flight work evacuates, queues hand back in arrival order), then
        the frontend's own pending pool is evacuated too and every stranded
        request is returned for the caller to re-route globally. The
        pre-blackout replica profile is remembered so ``restore`` can bring
        the cell back through normal provisioning."""
        self._blackout_profile = [
            len(n.live) + len(n.draining) + len(n.spawning)
            for n in self.nodes]
        for node in self.nodes:
            if node.down:
                continue
            node.preempt_left = -1    # a blackout supersedes any notice
            node.spawning = []
            for eng in list(node.live):
                self._drain(node, eng)
            self._preempt_finalize(node)
        out = list(self.pending)
        self.pending.clear()
        return out

    def restore(self) -> None:
        """Bring a blacked-out cell back: every down node recovers (empty)
        and the pre-blackout replica profile re-targets through the normal
        provisioning pipeline — capacity returns after the cold-start
        delay, exactly like any other scale-up."""
        for node in self.nodes:
            node.down = False
        if self._blackout_profile is not None:
            self.scale_to(np.asarray(self._blackout_profile, np.int32))
            self._blackout_profile = None

    def _preempt_finalize(self, node: _Node):
        """Notice expired: hard-drop every replica still finishing work
        (the failure path — reconcile-flush, evacuate, re-queue merged),
        hand the node queue back for global re-routing, mark the node
        down."""
        for eng in list(node.draining):
            self._destroy(node, eng, node.draining)
            self.preempted_replicas += 1
        for eng in list(node.live):      # defensive: nothing should be live
            self._destroy(node, eng, node.live)
            self.preempted_replicas += 1
        if node.queue:
            _requeue_merged(self.pending, node.queue)
            node.queue.clear()
        node.preempt_left = -1
        node.down = True
        self.preempted_nodes += 1

    def _advance_chaos(self):
        """Apply this tick's scripted chaos events, then advance preemption
        notice timers (a node whose notice hits zero finalizes here, so
        its evacuated work re-routes within the same tick)."""
        if self.chaos is not None:
            for kind, n, arg in self.chaos.pop(self.t):
                if kind not in ChaosSchedule.NODE_KINDS:
                    continue           # cell-kind events belong to the router
                if kind == "fail":
                    self.fail_replica(n, 0 if arg is None else arg)
                elif kind == "preempt":
                    self.preempt_node(n, notice=arg)
                elif kind == "slow":
                    self.slow_node(n, arg)
                else:
                    self.recover_node(n)
        for node in self.nodes:
            if node.preempt_left < 0:
                continue
            if node.preempt_left == 0:
                self._preempt_finalize(node)
            else:
                node.preempt_left -= 1

    def preempt_risk(self) -> np.ndarray:
        """Per-node preemption-risk signal for the GPSO planner: 1 while a
        node is under notice or down, else 0. All zeros when no chaos is
        active, which keeps the planner on its original Eq.9 objective
        (bit-parity with the pre-chaos stack)."""
        return np.asarray(
            [1.0 if (n.down or n.preempt_left >= 0) else 0.0
             for n in self.nodes], np.float32)

    def _fail(self, node: _Node, eng: ReplicaEngine):
        self._destroy(node, eng, node.live)
        self.failed_replicas += 1

    def _destroy(self, node: _Node, eng: ReplicaEngine, pool: list):
        if eng._fleet is not None:
            # pending futures must commit BEFORE progress resets — a stale
            # token applied after evacuate() would corrupt the re-queued
            # request's stream
            self._async_stash.extend(eng._fleet.reconcile(force=True))
        lost = eng.evacuate()
        # lost work re-queues at its original arrival position (it is
        # usually the oldest work on the node, so it retries first — but by
        # arrival accounting, not by a blanket prepend that would jump any
        # newer lost request ahead of older queued ones)
        _requeue_merged(node.queue, lost)
        pool.remove(eng)
        node.credit.pop(id(eng), None)
        self._leave_fleet(eng, restore=False)   # row dropped, not unstacked
        self._retired_replica_prefills += eng.prefill_dispatches
        self._retired_replica_syncs += eng.syncs
        self._retired_sync_wait += eng.sync_wait

    def _inject_failures(self):
        if self.failure_rate <= 0.0:
            return
        for node in self.nodes:
            for eng in list(node.live):
                if self.rng.random() < self.failure_rate:
                    self._fail(node, eng)

    # ------------------------------------------------------------- ticking
    def _advance_provisioning(self):
        for node in self.nodes:
            node.spawning = [d - 1 for d in node.spawning]
            ready = sum(1 for d in node.spawning if d <= 0)
            node.spawning = [d for d in node.spawning if d > 0]
            for _ in range(ready):
                self._go_live(node)

    def _generate_arrivals(self, arrival_rate: float):
        if self.request_factory is None or arrival_rate <= 0.0:
            return
        self._acc += arrival_rate * self.tick_seconds
        n = int(self._acc)
        self._acc -= n
        for _ in range(n):
            req = self.request_factory(self._req_id, self.t)
            self._req_id += 1
            req.arrival = float(self.t - 1)   # arrives as this tick begins
            self.ledger.register(req)         # fresh rid: always accepted
            self.pending.append(req)

    def _cull_expired(self) -> list:
        """Sweep ``pending`` and the node queues for requests whose
        deadline has already passed — admitting them would waste routing
        and a prefill on a request that could emit at most one truncated
        token. (Replica-queue heads are culled by ``plan_admission``; a
        deep replica queue is bounded by ``max_batch``.) Culled requests
        are stamped finished-now so the ledger resolves them timed-out.
        No-op when nothing carries a deadline (chaos-off parity)."""
        expired: list = []

        def cull(q):
            dead = [r for r in q if r.out_of_time(self.t)]
            if dead:
                keep = [r for r in q if not r.out_of_time(self.t)]
                q.clear()
                for r in keep:
                    q.append(r)
            expired.extend(dead)

        cull(self.pending)
        for node in self.nodes:
            cull(node.queue)
        for r in expired:
            r.finish_time = float(self.t)
        return expired

    def _reroute_stranded(self):
        """A node with queued work but no live or provisioning replicas would
        strand it forever — hand it back for global re-routing (the elastic
        twin of the fluid sim's retry pool)."""
        for node in self.nodes:
            if node.queue and not node.live and not node.spawning:
                _requeue_merged(self.pending, node.queue)
                node.queue.clear()

    def _route_pending(self):
        mask = self.up_mask()
        if not (mask > 0).any():
            return                      # nothing can serve; hold requests
        fr = normalize_fractions(self._fractions, mask=mask)
        while self.pending:
            idx = int(self.rng.choice(self.num_nodes, p=fr))
            self.nodes[idx].queue.append(self.pending.popleft())

    def _dispatch(self, node: _Node):
        """Fill free replica slots from the node queue (least-loaded first,
        normalized by speed so fast replicas pull more work). The node
        queue hands out work in tiered weighted-deficit order (``pop``, not
        ``popleft``): the deep backlog lives here, so this is where premium
        traffic overtakes — single-tier pops stay plain FIFO."""
        while node.queue:
            cands = [e for e in node.live if e.load < e.max_batch]
            if not cands:
                return
            eng = min(cands, key=lambda e: e.load / max(e.speed, 1e-6))
            eng.submit(node.queue.pop())

    @telemetry.spanned("frontend.tick")
    def tick(self, arrival_rate: float = 0.0) -> dict:
        self.t += 1
        prefill_before = self.prefill_dispatches()
        syncs_before = self.sync_count()
        replica_syncs_before = self.replica_sync_count()
        wait_before = self.sync_wait_s()
        self._tick_reconciles = 0
        # async reconcile point: commit the previous tick's in-flight device
        # results (retires free their slots HERE, before admission planning,
        # so admission timing matches the eager oracle exactly)
        finished_now: list = self._reconcile_all()
        with telemetry.span("frontend.arrivals"):
            self._advance_provisioning()
            self._advance_chaos()     # scripted events + notice timers: their
            self._inject_failures()   # hand-backs re-route this same tick
            self._generate_arrivals(arrival_rate)
            finished_now.extend(self._cull_expired())
            self._reroute_stranded()
            self._route_pending()
            self._tick_dispatches = round_start = 0
            stepping: list = []     # (engine, n_substeps) across ALL nodes
            for node in self.nodes:
                self._dispatch(node)
                for eng in list(node.live) + list(node.draining):
                    node.credit[id(eng)] = node.credit.get(id(eng), 0.0) + \
                        eng.speed * node.slow
                    n_sub = int(node.credit[id(eng)])
                    node.credit[id(eng)] -= n_sub
                    if n_sub <= 0:
                        continue
                    eng.clock = float(self.t - 1)
                    stepping.append((eng, n_sub))
        # sub-step rounds: round r advances every engine with n_sub > r, so
        # a homogeneous-speed cluster runs exactly one round and each fleet
        # group issues ONE decode dispatch (plus, under fleet admission, one
        # prefill dispatch per distinct bucket shape) for the whole tick.
        # Engines are independent within a tick (node queues were dispatched
        # above), so round interleaving matches stepping them one by one.
        max_sub = max((n for _, n in stepping), default=0)
        # a fused decode block may engage on single-round ticks whose
        # admission phase dispatched nothing (the group checks that);
        # unrouted work would mean admissions are imminent, so hold off
        allow_block = (self.decode_block > 1 and max_sub == 1
                       and not self.pending)
        for r in range(max_sub):
            with telemetry.span("frontend.round"):
                if r > 0 and self.async_tick:
                    # hetero sub-rounds: round r's admission may use slots
                    # the previous round's decode freed, so reconcile
                    # between rounds (homogeneous clusters run one round =
                    # one sync per tick)
                    finished_now.extend(self._reconcile_all())
                round_engines = [(e, n) for e, n in stepping if n > r]
                ids = {id(e) for e, _ in round_engines}
                for eng, n in round_engines:
                    finished_now.extend(eng.begin_step(
                        dt=1.0 / n,
                        admit=eng._fleet is None or not self.fleet_prefill))
                if self.fleet_prefill:
                    for g in self._fleets.values():
                        finished_now.extend(g.admit_round(ids))
                round_start = self._tick_dispatches
                for g in self._fleets.values():
                    before = g.dispatches
                    finished_now.extend(g.decode_round(
                        ids, allow_block=allow_block))
                    self._tick_dispatches += g.dispatches - before
                for eng, _ in round_engines:     # engines outside any fleet
                    if eng._fleet is None:
                        if eng.n_decoding:
                            self._tick_dispatches += 1
                        finished_now.extend(eng.finish_step())
        self._tick_last_round = self._tick_dispatches - round_start
        for node in self.nodes:
            for eng in list(node.draining):   # retire drained replicas
                if eng.load == 0:
                    node.draining.remove(eng)
                    node.credit.pop(id(eng), None)
                    # retired-empty: nothing worth unstacking from the slab
                    self._leave_fleet(eng, restore=False)
                    self._retired_replica_prefills += \
                        eng.prefill_dispatches
                    self._retired_replica_syncs += eng.syncs
                    self._retired_sync_wait += eng.sync_wait
            self.replica_ticks += len(node.live)
        self._tick_prefill_dispatches = \
            self.prefill_dispatches() - prefill_before
        self._tick_syncs = self.sync_count() - syncs_before
        self._tick_replica_syncs = \
            self.replica_sync_count() - replica_syncs_before
        self._tick_sync_wait = self.sync_wait_s() - wait_before
        # finishes force-flushed by mid-tick churn (drain retires, failure
        # evacuations) land in stashes — collect them NOW so a drain loop
        # that terminates on this tick doesn't strand them
        for g in self._fleets.values():
            finished_now.extend(g.take_stash())
        finished_now.extend(self._async_stash)
        self._async_stash = []
        self.finished.extend(finished_now)
        # conservation: land every completion in its terminal ledger state
        # (goodput = in-deadline finishes for a client that still wants
        # them; expired ones are timed_out; abandoned rids count wasted)
        self._tick_goodput = self._tick_timed_out = 0
        for r in finished_now:
            end = self.ledger.resolve(r)
            if end == "finished":
                self._tick_goodput += 1
            elif end == "timed_out":
                self._tick_timed_out += 1
        self._m = self._compute_metrics(finished_now, arrival_rate)
        return self._m

    # -------------------------------------------------------------- metrics
    def _update_service_rate(self, finished_now: list):
        """EMA of measured per-replica requests/tick, fed to the autoscaler
        in place of the static ``unit_capacity`` once warm. Only ticks where
        the cluster is actually serving (work in flight or completions) count
        — idle ticks would drag the estimate to zero."""
        # draining replicas still finish work, so they count as servers —
        # dividing by live only would inflate the rate during scale-downs
        serving = sum(len(n.live) + len(n.draining) for n in self.nodes)
        busy = finished_now or any(n.unfinished() for n in self.nodes)
        if serving <= 0 or not busy:
            return
        rate = len(finished_now) / serving
        if self._srv_rate is None:
            self._srv_rate = rate
        else:
            self._srv_rate += _SERVICE_RATE_ALPHA * (rate - self._srv_rate)
        self._srv_obs += 1

    @property
    def service_rate(self) -> Optional[float]:
        """Measured per-replica req/tick, or None until the EMA warms up."""
        if self._srv_obs < _SERVICE_RATE_WARMUP or not self._srv_rate:
            return None
        return float(self._srv_rate)

    def tier_depths(self) -> np.ndarray:
        """Per-tier unfinished work per node, (T, N) in tier declaration
        order — node queues plus every replica's queued + in-flight slots.
        Counts come from the structures' own per-tier bookkeeping
        (``TieredQueue.depths`` / ``ReplicaEngine.tier_load``); a replica
        built with a different tier config falls back to counting its
        requests under the frontend's tier set."""
        out = np.zeros((len(self.tiers), self.num_nodes), np.float32)
        for i, node in enumerate(self.nodes):
            out[:, i] += node.queue.depths()
            for eng in list(node.live) + list(node.draining):
                tl = eng.tier_load()
                if len(tl) == len(self.tiers):
                    out[:, i] += tl
                else:
                    for req in list(eng.queue) + \
                            [r for r in eng.slots if r is not None]:
                        out[self.tiers.index(req.tier), i] += 1
        return out

    def _overdue_waiting(self) -> dict:
        """Per-tier count of requests still waiting for their first token
        whose age already exceeds the tier's TTFT target. Without this, a
        *starved* tier would report zero SLO violation — only completed
        requests can register a miss, and the reward would go unpenalized
        exactly when the tier is most violated."""
        overdue = {n: 0 for n in self.tiers.names}
        finite = [s for s in self.tiers.specs if np.isfinite(s.ttft_target)]
        if not finite:
            return overdue
        pools = [self.pending]
        for node in self.nodes:
            pools.append(node.queue)
            for eng in list(node.live) + list(node.draining):
                pools.append(eng.queue)
                pools.append(r for r in eng.slots if r is not None)
        for pool in pools:
            for req in pool:
                if req.first_token_time is not None:
                    continue
                spec = self.tiers.specs[self.tiers.index(req.tier)]
                if self.t - req.arrival > spec.ttft_target:
                    overdue[spec.name] += 1
        return overdue

    def _tier_metrics(self, finished_now: list) -> dict:
        """Per-tier latency/SLO view of this tick: queue depths, weighted
        pressure (the GPSO SLO-cost signal), TTFT/TBT means over this
        tick's completions and the tier-weighted SLO violation level the
        Eq.5 reward consumes (this tick's target misses plus the
        already-overdue waiting requests, so starvation is visible before
        anything completes). Untiered frontends emit NO tier keys — the
        control plane must keep planning with the original Eq.9/Eq.5
        objectives, bit-identical to the pre-tier behavior (a single-tier
        ``tier_pressure`` would be plain queue depth and silently flip the
        planner onto the tiered fitness)."""
        if len(self.tiers) <= 1:
            return {}
        tiers = self.tiers
        tq = self.tier_depths()
        overdue = self._overdue_waiting()
        ttft: dict = {}
        tbt: dict = {}
        served: dict = {n: 0 for n in tiers.names}
        viol: dict = {}
        for spec in tiers.specs:
            rows = [r for r in finished_now if tiers.index(r.tier)
                    == tiers.index(spec.name)]
            # queue-culled expired requests never got a first token: they
            # are SLO misses, not latency samples
            done = [r for r in rows if r.first_token_time is not None]
            served[spec.name] = len(done)
            late = overdue[spec.name]
            misses = late + (len(rows) - len(done))
            if done:
                ft = [r.first_token_time - r.arrival for r in done]
                bt = [(r.finish_time - r.first_token_time)
                      / max(len(r.output) - 1, 1) for r in done]
                ttft[spec.name] = float(np.mean(ft))
                tbt[spec.name] = float(np.mean(bt))
                misses += sum(float(f > spec.ttft_target
                                    or b > spec.tbt_target)
                              for f, b in zip(ft, bt))
            denom = len(rows) + late
            if denom:
                viol[spec.name] = misses / denom
        return {
            "tier_queue": tq,
            "tier_pressure": tiers.pressure(tq),
            "tier_ttft": ttft,
            "tier_tbt": tbt,
            "tier_served": served,
            "tier_slo_cost": tiers.slo_cost(viol),
        }

    def _compute_metrics(self, finished_now: list, arrival_rate: float) -> dict:
        for r in finished_now:
            self._est_tokens += 0.05 * (len(r.output) - self._est_tokens)
        self._update_service_rate(finished_now)
        q = self.queue_depths()
        slots = np.asarray(
            [sum(e.max_batch for e in n.live) for n in self.nodes],
            np.float32)
        # demand/capacity utilization, saturating at 1 under backlog — the
        # same semantics as the fluid sim's served/capacity (a pure busy-slot
        # fraction dips between retire and re-admit and never signals
        # saturation to the HPA/RBAS threshold rules).
        util = np.where(slots > 0,
                        np.clip(q / np.maximum(slots, 1e-9), 0.0, 1.0), 0.0)
        up = self.up_mask()
        req_cap = self.request_capacity()
        if finished_now:
            resp = float(np.mean([r.finish_time - r.arrival
                                  for r in finished_now]))
            self._resp_est = resp
        else:
            # queueing estimate: backlog / service rate + one service time
            backlog = np.where(req_cap > 1e-9,
                               q / np.maximum(req_cap, 1e-9), 10.0)
            est = float(np.mean(backlog)) + self._est_tokens
            resp = max(self._resp_est, est) if q.sum() > 0 else self._resp_est
        overload = float(np.mean(np.where(
            req_cap > 1e-9,
            np.clip(q / np.maximum(req_cap, 1e-9) / 4.0, 0, 1), 1.0)))
        return {
            "utilization": util.astype(np.float32),
            "mean_utilization": float(np.mean(util[up > 0.5])
                                      if (up > 0.5).any() else 0.0),
            "response_time": resp,
            "served": float(len(finished_now)),
            "served_tokens": float(sum(len(r.output) for r in finished_now)),
            "overload": overload,
            "capacity": req_cap,
            "queue": q,
            "up": up,
            "active_replicas": np.asarray(
                [len(n.live) for n in self.nodes], np.int32),
            "replica_ticks": int(sum(len(n.live) for n in self.nodes)),
            "decode_dispatches": int(self._tick_dispatches),
            "prefill_dispatches": int(self._tick_prefill_dispatches),
            "syncs": int(self._tick_syncs),
            "sync_wait_s": float(self._tick_sync_wait),
            "fleet_groups": int(sum(1 for g in self._fleets.values()
                                    if len(g))),
            # the async tick's sync accounting: ``reconciles`` of ``syncs``
            # came at the reconcile points (the rest are churn flushes); the
            # last round's fleet dispatches stay in flight past the tick
            "reconciles": int(self._tick_reconciles),
            "replica_syncs": int(self._tick_replica_syncs),
            "last_round_dispatches": int(self._tick_last_round),
            "in_flight_groups": int(sum(1 for g in self._fleets.values()
                                        if g.pending)),
            "service_rate": self.service_rate,
            # robustness view: all zeros when chaos/clients are off, so
            # the planner (guarded by .any()) and reward see no change
            "goodput": float(self._tick_goodput),
            "timed_out": float(self._tick_timed_out),
            "preempt_risk": self.preempt_risk(),
            # multi-cell view (PR 8): a single frontend IS one healthy cell
            # — staleness/risk/shed are identically zero here, and the
            # routing plane overrides them with real per-cell values. Key
            # presence is constant so planner guards stay shape-stable.
            "cell_staleness": np.zeros(1, np.float32),
            "cell_risk": np.zeros(1, np.float32),
            "shed": 0.0,
            # hierarchical-control view (PR 10): a single frontend has no
            # global plane above it and no lease unless the hierarchy set
            # one — identically zero here; MultiCellBackend overrides with
            # real plane-staleness / lease-utilization / local-action
            # counts. Key presence is constant (same contract as above).
            "plane_staleness": 0.0,
            "lease_util": np.zeros(1, np.float32),
            "local_actions": 0.0,
            **self._tier_metrics(finished_now),
        }

    # ------------------------------------------------------------ draining
    def run_until_drained(self, max_steps: int = 10_000):
        """Finish all outstanding work (controlled wind-down: chaos
        injection pauses so the backlog can actually clear)."""
        rate, self.failure_rate = self.failure_rate, 0.0
        chaos, self.chaos = self.chaos, None   # scripted events pause too;
        try:                                   # notice timers still expire
            for _ in range(max_steps):
                # safety: if scaling/failures left the whole cluster with no
                # capacity while work is outstanding, spawn one drain worker
                # (an aggressive scale-to-zero must never drop requests) —
                # on a node that is neither preempted-down nor under notice
                if (self.pending or any(n.unfinished() for n in self.nodes)) \
                        and not any(n.live or n.spawning for n in self.nodes):
                    host = next((n for n in self.nodes
                                 if not n.down and n.preempt_left < 0), None)
                    if host is None:           # everything preempted away:
                        host = self.nodes[0]   # force one node back up
                        host.down = False
                    self._go_live(host)
                self.tick(0.0)
                if not self.pending and all(n.unfinished() == 0
                                            for n in self.nodes):
                    return
            raise RuntimeError("elastic cluster did not drain")
        finally:
            self.failure_rate = rate
            self.chaos = chaos
