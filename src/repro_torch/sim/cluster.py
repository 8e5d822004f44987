"""Fluid discrete-time cluster simulator for inference serving (the port of
``repro.sim.cluster``).

Models N serving nodes, each holding ``replicas`` model replicas of
``unit_capacity`` requests/s (``repro_torch.sim.service_rate`` derives one
from an arch's decode roofline). Per tick:

    arrivals --balancer fractions a_i--> per-node queues
    served_i = min(queue_i, capacity_i·dt)
    response_i ≈ queue_after/capacity (queueing) + 1/unit_rate (service)

plus the operational realities the paper's framework must survive at scale:
cold-start provisioning delay for new replicas, Poisson node failures with
repair times (queued work is re-routed), and straggler nodes with degraded
capacity.

**Where it runs.** The tick's queueing update (``_tick_math``) is tensor
code over (N,)-vectors on ``device`` (default ``"cuda"``), as the
reference's jitted update runs on its device: one host-to-device copy of
the tick's operands and one device-to-host copy of its results a tick
(``fetches`` counts the latter; the reference reads ``q2`` back every tick
too). The bookkeeping around it -- provisioning, failures, stragglers,
chaos, tiers, leases -- stays numpy on the host, drawn from the numpy
generator in the reference's order, so a seed gives the reference's
episode.

**SLO tiers.** With ``tiers=TierSet(...)`` the per-node backlog is tracked
per priority class, mirroring the request-level engine's tiered queues:
arrivals split by tier share, and each node's served capacity drains tiers
in priority order (premium first -- the fluid limit of weighted-deficit
admission under saturation). The aggregate dynamics are those of the
untiered sim (the same ``_tick_math`` runs on the summed queue); tiering
adds the per-tier breakdown the control plane observes: ``tier_queue``
(T, N), ``tier_pressure`` (N,) weighted backlog, ``tier_response`` per-tier
latency estimates and the tier-weighted ``tier_slo_cost`` for the Eq.5
reward -- the same metric keys the elastic backend emits.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import host_to_device, resolve_device
from repro_torch.workload.trace import TierSet


@dataclasses.dataclass
class ClusterState:
    queue: np.ndarray          # (N,) outstanding work (request-units)
    active: np.ndarray         # (N,) active replicas
    pending: np.ndarray        # (N, D) replicas arriving in d ticks
    up: np.ndarray             # (N,) 1 healthy / 0 failed
    down_left: np.ndarray      # (N,) ticks of repair remaining
    slow: np.ndarray           # (N,) straggler capacity multiplier
    slow_left: np.ndarray      # (N,) ticks of degradation remaining
    retry_pool: float          # work dropped from failed nodes, re-enqueued
    notice_left: np.ndarray    # (N,) spot-preemption notice ticks; -1 = none


def init_state(n_nodes: int, replicas: int, delay: int) -> ClusterState:
    return ClusterState(
        queue=np.zeros(n_nodes, np.float32),
        active=np.full(n_nodes, replicas, np.int32),
        pending=np.zeros((n_nodes, delay), np.int32),
        up=np.ones(n_nodes, np.float32),
        down_left=np.zeros(n_nodes, np.int32),
        slow=np.ones(n_nodes, np.float32),
        slow_left=np.zeros(n_nodes, np.int32),
        retry_pool=0.0,
        notice_left=np.full(n_nodes, -1, np.int32),
    )


def _tick_math(queue, capacity, fractions, arrivals, dt, service_time):
    """Pure per-tick queueing update over f32 tensors on one device:
    queue, capacity, fractions (N,); arrivals, dt, service_time 0-d.
    Returns per-node metrics (q2, served, util) and the 0-d mean_resp and
    overload."""
    arr = arrivals * dt * fractions
    q1 = queue + arr
    served = torch.minimum(q1, capacity * dt)
    q2 = q1 - served
    util = torch.where(capacity > 1e-9,
                       served / torch.clamp(capacity * dt, min=1e-9), 0.0)
    # delay a marginal arrival faces: residual queue / capacity + service
    resp = torch.where(capacity > 1e-9,
                       q2 / torch.clamp(capacity, min=1e-9), 10.0) \
        + service_time
    # arrival-weighted mean response
    total = torch.sum(arr)
    w = torch.where(total > 1e-9, arr / torch.clamp(total, min=1e-9),
                    torch.ones_like(arr) / arr.shape[0])
    mean_resp = torch.sum(w * resp)
    overload = torch.mean(torch.where(
        capacity * dt > 1e-9,
        torch.clamp(q2 / torch.clamp(capacity * dt, min=1e-9), 0, 1), 1.0))
    return q2, served, util, mean_resp, overload


@dataclasses.dataclass
class ClusterSim:
    cfg: "ClusterConfig"
    unit_capacity: float                  # req/s per replica (from roofline)
    seed: int = 0
    failures: bool = True

    heterogeneous: bool = True
    tiers: Optional[TierSet] = None   # None -> untiered (single class)
    # scripted chaos (duck-typed ``serving.elastic.ChaosSchedule``: any
    # object with ``pop(tick) -> [(kind, node, arg)]``) and the default
    # spot-preemption notice length — the fluid mirror of the elastic
    # frontend's failure matrix
    chaos: Optional[object] = None
    preempt_notice: int = 0
    device: object = "cuda"   # where _tick_math runs

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.fetches = 0      # device-to-host reads of the tick's results
        self.rng = np.random.default_rng(self.seed)
        self.state = init_state(self.cfg.num_nodes,
                                max(1, self.cfg.max_replicas_per_node // 2),
                                self.cfg.provisioning_delay)
        self.service_time = 1.0 / self.unit_capacity
        self.tick_count = 0
        # per-tier backlog breakdown (invariant: sums to state.queue). A
        # single-tier set stays untiered: emitting tier_pressure (== plain
        # queue depth) would silently flip the GPSO planner onto the tiered
        # objective — the same guard the elastic backend applies, keeping
        # the two backends' metric key sets identical per tier config.
        self.tier_queue = None
        if self.tiers is not None and len(self.tiers) > 1:
            self.tier_queue = np.zeros((len(self.tiers), self.cfg.num_nodes),
                                       np.float32)
        # mixed hardware generations: persistent per-node speed multipliers
        if self.heterogeneous:
            self.node_speed = self.rng.choice(
                [0.6, 1.0, 1.4], size=self.cfg.num_nodes,
                p=[0.25, 0.5, 0.25]).astype(np.float32)
        else:
            self.node_speed = np.ones(self.cfg.num_nodes, np.float32)
        # preempted-away nodes: down until an explicit recover event (unlike
        # ordinary failures, which self-repair after ~mttr and keep their
        # replicas). Tracked separately so scale_to can refuse to provision
        # onto them without changing the ordinary-failure dynamics.
        self._preempt_down = np.zeros(self.cfg.num_nodes, bool)
        # deterministic straggler overlay (slow@t:nI:xF): multiplies into
        # capacity alongside the stochastic episode state, and survives
        # _advance_failures recomputing state.slow from slow_left each tick
        self._forced_slow = np.ones(self.cfg.num_nodes, np.float32)
        self._lease: Optional[tuple] = None   # (min, max) total replicas

    # ------------------------------------------------------------ dynamics
    def capacity(self) -> np.ndarray:
        s = self.state
        return (s.active * self.unit_capacity * self.node_speed * s.up *
                s.slow * self._forced_slow).astype(np.float32)

    def set_lease(self, min_replicas: int, max_replicas: int) -> None:
        """Bound future ``scale_to`` calls to a capacity lease on the cell's
        TOTAL in-flight replica count (fluid mirror of
        ``ElasticClusterFrontend.set_lease``)."""
        lo, hi = int(min_replicas), int(max_replicas)
        if lo < 0 or hi < lo:
            raise ValueError(f"bad lease [{min_replicas}, {max_replicas}]")
        self._lease = (lo, hi)

    def clear_lease(self) -> None:
        self._lease = None

    @property
    def lease(self):
        return self._lease

    def scale_to(self, target: np.ndarray):
        """Apply an autoscaler plan: scale-ups go through the provisioning
        pipeline (cold start); scale-downs are immediate. A capacity lease
        (``set_lease``) clamps the cell total first."""
        s = self.state
        target = np.asarray(target, np.int32)
        in_flight = s.active + s.pending.sum(axis=1)
        # never provision onto a node under a preemption notice or already
        # preempted away (ordinary failed nodes still accept adds: they
        # come back with their replicas after repair)
        doomed = (s.notice_left >= 0) | self._preempt_down
        if self._lease is not None:
            lo, hi = self._lease
            # adds on doomed nodes are suppressed below, so their effective
            # target never exceeds what they already hold
            eff = np.where(doomed, np.minimum(target, in_flight),
                           target).astype(np.int64)
            total = int(eff.sum())
            sched = np.nonzero(~doomed)[0]
            while total > hi and sched.size:
                cand = [i for i in sched if eff[i] > 0]
                if not cand:
                    break
                i = max(cand, key=lambda j: (eff[j], -j))
                eff[i] -= 1
                total -= 1
            while total < lo and sched.size:
                cand = [i for i in sched
                        if eff[i] < self.cfg.max_replicas_per_node]
                if not cand:
                    break
                i = min(cand, key=lambda j: (eff[j], j))
                eff[i] += 1
                total += 1
            target = eff.astype(np.int32)
        add = np.maximum(target - in_flight, 0)
        add = np.where(doomed, 0, add)
        if add.any():
            s.pending[:, -1] += add
        down = np.maximum(in_flight - target, 0)
        if down.any():
            # remove pending first, then active
            for i in np.nonzero(down)[0]:
                rem = down[i]
                for d in range(s.pending.shape[1] - 1, -1, -1):
                    take = min(rem, s.pending[i, d])
                    s.pending[i, d] -= take
                    rem -= take
                s.active[i] = max(s.active[i] - rem, 0)

    def _advance_provisioning(self):
        s = self.state
        s.active = s.active + s.pending[:, 0]
        s.pending = np.roll(s.pending, -1, axis=1)
        s.pending[:, -1] = 0

    # ------------------------------------------------------------- chaos
    def _check_node(self, i: int):
        if not isinstance(i, (int, np.integer)) \
                or not 0 <= i < self.cfg.num_nodes:
            raise ValueError(
                f"node index {i!r} out of range for {self.cfg.num_nodes} "
                "nodes")

    def preempt_node(self, i: int, notice: Optional[int] = None):
        """Spot-preemption notice on node ``i`` (the fluid mirror of
        ``ElasticClusterFrontend.preempt_node``): spawns cancel now, the
        node keeps draining its queue for the notice window, then whatever
        backlog remains dumps into the retry pool and the node goes down
        until an explicit ``recover_node``."""
        self._check_node(i)
        s = self.state
        if s.up[i] < 0.5:
            raise ValueError(f"node n{i} is already down")
        if s.notice_left[i] >= 0:
            raise ValueError(f"node n{i} already has a preemption notice")
        left = self.preempt_notice if notice is None else int(notice)
        s.pending[i, :] = 0
        if left <= 0:
            self._preempt_finalize(i)
        else:
            s.notice_left[i] = left

    def recover_node(self, i: int):
        self._check_node(i)
        s = self.state
        if not self._preempt_down[i]:
            raise ValueError(f"node n{i} is not preempted away")
        self._preempt_down[i] = False
        s.up[i] = 1.0
        s.down_left[i] = 0

    def slow_node(self, i: int, factor: int):
        """Deterministic straggler injection (``slow@t:nI:xF``), fluid
        mirror of ``ElasticClusterFrontend.slow_node``: node ``i``'s
        capacity multiplies by 1/``factor`` until cleared with
        ``factor == 1``. Lives in a separate overlay so the stochastic
        straggler episodes (``straggler_prob``) keep their own dynamics."""
        self._check_node(i)
        if factor is None or not isinstance(factor, (int, np.integer)):
            raise ValueError(
                f"slow factor must be an int >= 1, got {factor!r}")
        if factor < 1:
            raise ValueError(f"slow factor must be >= 1, got {factor}")
        if self._preempt_down[i]:
            raise ValueError(f"node n{i} is down (preempted); nothing to slow")
        self._forced_slow[i] = 1.0 / int(factor)

    def _preempt_finalize(self, i: int):
        s = self.state
        s.retry_pool += float(s.queue[i])
        s.queue[i] = 0.0
        if self.tier_queue is not None:
            self.tier_queue[:, i] = 0.0
        s.active[i] = 0
        s.pending[i, :] = 0
        s.up[i] = 0.0
        s.down_left[i] = 2**30       # no self-repair: recovery is scripted
        s.notice_left[i] = -1
        self._preempt_down[i] = True

    def blackout(self) -> float:
        """Cell blackout, fluid mirror of the elastic frontend's evacuation
        hook: every node preempts immediately (notices superseded, spawns
        cancelled) and the evacuated backlog mass — which lands in the
        retry pool — is drained out and returned for the routing plane to
        re-inject into sibling cells. Remembers the replica profile for
        ``restore``."""
        s = self.state
        self._blackout_profile = (s.active + s.pending.sum(axis=1)).copy()
        for i in range(self.cfg.num_nodes):
            if self._preempt_down[i]:
                continue
            s.notice_left[i] = -1
            s.pending[i, :] = 0
            self._preempt_finalize(i)
        work, s.retry_pool = float(s.retry_pool), 0.0
        return work

    def restore(self) -> None:
        """Recover every preempted-away node and re-target the pre-blackout
        replica profile through the provisioning pipeline (cold start)."""
        for i in range(self.cfg.num_nodes):
            if self._preempt_down[i]:
                self.recover_node(i)
        prof = getattr(self, "_blackout_profile", None)
        if prof is not None:
            self.scale_to(prof)
            self._blackout_profile = None

    def _advance_chaos(self):
        if self.chaos is not None:
            for kind, i, arg in self.chaos.pop(self.tick_count + 1):
                if kind not in ("preempt", "fail", "recover", "slow"):
                    continue     # cell/plane-kind events belong to the router
                if kind == "preempt":
                    self.preempt_node(i, notice=arg)
                elif kind == "recover":
                    self.recover_node(i)
                elif kind == "slow":
                    self.slow_node(i, arg)
                else:                 # "fail": whole node, ordinary repair
                    self._check_node(i)
                    s = self.state
                    if s.up[i] < 0.5:
                        raise ValueError(f"node n{i} is already down")
                    s.up[i] = 0.0
                    s.down_left[i] = self.rng.geometric(
                        1.0 / self.cfg.node_mttr)
                    s.retry_pool += float(s.queue[i])
                    s.queue[i] = 0.0
                    if self.tier_queue is not None:
                        self.tier_queue[:, i] = 0.0
        s = self.state
        for i in np.nonzero(s.notice_left >= 0)[0]:
            if s.notice_left[i] == 0:
                self._preempt_finalize(i)
            else:
                s.notice_left[i] -= 1

    def preempt_risk(self) -> np.ndarray:
        """Per-node spot-churn signal for the planner: 1 under notice or
        preempted away, else 0 (all zeros when chaos never fired)."""
        s = self.state
        return ((s.notice_left >= 0) | self._preempt_down).astype(np.float32)

    def _advance_failures(self):
        if not self.failures:
            return
        s, cfg = self.state, self.cfg
        n = cfg.num_nodes
        # recoveries
        s.down_left = np.maximum(s.down_left - 1, 0)
        recovered = (s.up < 0.5) & (s.down_left == 0)
        s.up[recovered] = 1.0
        # new failures
        fail = (self.rng.random(n) < 1.0 / cfg.node_mtbf) & (s.up > 0.5)
        if fail.any():
            s.up[fail] = 0.0
            s.down_left[fail] = self.rng.geometric(1.0 / cfg.node_mttr,
                                                   fail.sum())
            # failed nodes drop their queue into the retry pool (tier
            # identity dissolves there; re-arrivals re-split by share)
            s.retry_pool += float(s.queue[fail].sum())
            s.queue[fail] = 0.0
            if self.tier_queue is not None:
                self.tier_queue[:, fail] = 0.0
        # stragglers: degradation episodes persist for a sampled duration
        # (like failures do). Onset probability is normalized by the mean
        # episode length so the steady-state degraded node fraction stays
        # ~straggler_prob.
        s.slow_left = np.maximum(s.slow_left - 1, 0)
        mean_dur = max(cfg.straggler_mean_ticks, 1.0)
        onset = (self.rng.random(n) < cfg.straggler_prob / mean_dur) & \
            (s.slow_left == 0)
        if onset.any():
            s.slow_left[onset] = self.rng.geometric(1.0 / mean_dur,
                                                    onset.sum())
        s.slow = np.where(s.slow_left > 0, cfg.straggler_slowdown,
                          1.0).astype(np.float32)

    # ---------------------------------------------------------------- tick
    def tick(self, arrivals: float, fractions: np.ndarray) -> dict:
        """One dt step. fractions: (N,) simplex allocation from a balancer."""
        cfg = self.cfg
        self._advance_provisioning()
        self._advance_chaos()
        self._advance_failures()
        s = self.state
        arrivals = float(arrivals) + s.retry_pool / max(cfg.tick_seconds, 1e-9)
        s.retry_pool = 0.0
        cap = self.capacity()
        n = cfg.num_nodes
        # one copy of the operands to the device, one of the results back
        ops = host_to_device(np.concatenate([
            s.queue, cap, np.asarray(fractions, np.float32),
            np.array([arrivals, cfg.tick_seconds, self.service_time],
                     np.float32)]), self.device)
        q2, served, util, mean_resp, overload = _tick_math(
            ops[:n], ops[n:2 * n], ops[2 * n:3 * n], ops[3 * n],
            ops[3 * n + 1], ops[3 * n + 2])
        out = torch.cat([q2, served, util, mean_resp[None],
                         overload[None]]).cpu().numpy()
        self.fetches += 1
        q2, served, util_np = out[:n], out[n:2 * n], out[2 * n:3 * n]
        mean_resp, overload = out[3 * n], out[3 * n + 1]
        s.queue = q2.copy()     # failure events mutate it in place
        self.tick_count += 1
        m = {
            "utilization": util_np,
            "mean_utilization": float(np.mean(util_np[s.up > 0.5])
                                      if (s.up > 0.5).any() else 0.0),
            "response_time": float(mean_resp),
            "served": float(served.sum()),
            "overload": float(overload),
            "capacity": cap,
            "queue": s.queue.copy(),
            "up": s.up.copy(),
            "active_replicas": s.active.copy(),
            "replica_ticks": int(s.active.sum()),
            # multi-cell view: one sim is one healthy cell — zeros
            # here; the routing plane overrides with real per-cell values
            "cell_staleness": np.zeros(1, np.float32),
            "cell_risk": np.zeros(1, np.float32),
            "shed": 0.0,
            # hierarchical-control view: zeros for the same reason
            "plane_staleness": 0.0,
            "lease_util": np.zeros(1, np.float32),
            "local_actions": 0.0,
        }
        if self.tier_queue is not None:
            m.update(self._tier_tick(
                arrivals * cfg.tick_seconds * np.asarray(fractions,
                                                         np.float64),
                np.asarray(served, np.float64), cap))
        return m

    def _tier_tick(self, node_arrivals: np.ndarray, served: np.ndarray,
                   cap: np.ndarray) -> dict:
        """Per-tier bookkeeping around the aggregate update: split this
        tick's arrivals by tier share, drain each node's served mass through
        the tiers in priority order (premium first), and emit the same
        per-tier metric keys the elastic backend computes. The aggregate
        queue is untouched — Σ_t tier_queue == state.queue stays invariant
        up to float rounding."""
        tiers = self.tiers
        tq = self.tier_queue
        tq += tiers.shares[:, None] * node_arrivals[None, :]
        remaining = served.copy()
        for t in tiers.priority:              # premium drains first
            take = np.minimum(tq[t], remaining)
            tq[t] -= take
            remaining -= take
        np.clip(tq, 0.0, None, out=tq)
        # per-tier response estimate: a tier's marginal request waits behind
        # all backlog at its priority or higher, then one service time
        resp = {}
        viol = {}
        ahead = np.zeros(tq.shape[1], np.float64)
        up = self.state.up > 0.5
        for t in tiers.priority:
            ahead += tq[t]
            per_node = np.where(cap > 1e-9, ahead / np.maximum(cap, 1e-9),
                                10.0) + self.service_time
            spec = tiers.specs[t]
            r = float(np.mean(per_node[up]) if up.any() else 10.0)
            resp[spec.name] = r
            if np.isfinite(spec.ttft_target):
                viol[spec.name] = float(np.clip(
                    r / spec.ttft_target - 1.0, 0.0, 1.0))
        return {
            "tier_queue": tq.copy(),
            "tier_pressure": tiers.pressure(tq),
            "tier_response": resp,
            "tier_slo_cost": tiers.slo_cost(viol),
        }

    # ------------------------------------------------------- observations
    def observation(self, forecast: np.ndarray) -> np.ndarray:
        """Paper Eq.1-3 state: per-node [load, utilization-proxy, capacity,
        up] ++ forecast horizon (broadcast). (N, 4+T)."""
        s = self.state
        cap = self.capacity()
        total_cap = max(cap.sum(), 1e-9)
        load = s.queue / max(s.queue.sum(), 1.0)
        util_proxy = np.minimum(s.queue / np.maximum(cap, 1e-9), 4.0) / 4.0
        capn = cap / total_cap
        f = np.broadcast_to(forecast[None, :],
                            (self.cfg.num_nodes, forecast.shape[0]))
        obs = np.concatenate([load[:, None], util_proxy[:, None],
                              capn[:, None], s.up[:, None], f], axis=1)
        return obs.astype(np.float32)
