"""Decentralized two-level control: per-cell autoscalers under capacity
leases, with a crash-tolerant global plane (the port of
``repro.control.hierarchy``).

The paper's fault-tolerance claim is that *decentralised decision-making*
keeps scaling responsive when the central coordinator degrades. With
exactly one brain (``ControlPlane`` over ``MultiCellBackend``) a plane
outage freezes ALL autoscaling even while every cell is healthy. This
module splits control in two (the OptScaler
pattern: autonomous local reactive correctors bounded by a slower global
proactive plan):

  * ``CellController`` — one per cell, runs a reactive scale rule on the
    cell's OWN live signals every tick (local state is never stale), but
    only inside the cell's current **capacity lease**. Rule: sustained
    high utilization or queue-over-capacity adds replicas toward the
    lease max; sustained idleness retires them toward the lease min. All
    actions go through ``MultiCellBackend.scale_cell`` and the cell
    backend's own lease clamp, and are reported via
    ``note_local_action`` (→ the ``local_actions`` metric).
  * ``CellLease`` — ``[min_replicas, max_replicas]`` bounds plus the
    planner's proactive ``budget`` set-point. Granting a lease installs
    the bounds on the cell backend itself (``set_lease``), so even a
    confused global plane replaying a stale plan cannot overshoot.
  * ``GlobalPlanner`` — re-plans cross-cell leases every
    ``plan_interval`` ticks from the per-cell ``MetricsView``
    staleness/risk signals the router already maintains: demand shares
    (queue + in-flight work) are discounted by confidence decay on stale
    views and by preemption risk, budgets split a global replica budget
    proportionally, and ``lease_slack`` opens headroom above the budget
    for the local controllers to react into.
  * ``PlaneSupervisor`` — owns the global tick: while the plane is alive
    it steps the (optional) ``ControlPlane`` for forecasting/balancing
    and re-grants leases on the planner cadence; when
    ``MultiCellBackend.plane_alive`` goes false (``plane_down@t`` chaos)
    it ticks the backend directly — no global observation, no balancing,
    no lease changes — while every ``CellController`` keeps scaling
    inside its LAST lease at full tick rate. ``checkpoint()`` /
    ``restore()`` carry planner + plane + lease state across a crash: a
    freshly constructed supervisor that loads the checkpoint continues
    the exact decision stream (bit-identical plans and token streams —
    asserted in ``tests/test_hierarchy.py``). On the down→up transition
    the supervisor *reconciles*: it re-plans immediately from live cell
    state rather than replaying pre-crash scale targets, so no action is
    double-applied and the global ``RequestLedger`` stays exactly-once
    throughout (``double_served == 0``).

Outage semantics are deterministic: ``plane_down@t[:kK]`` lands inside
backend tick ``t`` (views start aging that tick); the supervisor observes
``plane_alive == False`` from the following ``step`` and suppresses the
global plane until the tick after ``plane_up`` lands. Scale-reaction
latency — ticks from a burst's onset to the first scale-up action — is
the headline A/B stat (`benchmarks/serve_bench.py` ``plane_outage``):
hierarchical control reacts during the outage, the centralized-frozen
baseline cannot react until restore.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.control.cells import MultiCellBackend


@dataclasses.dataclass
class CellLease:
    """Capacity lease for one cell: hard ``[min_replicas, max_replicas]``
    bounds on the cell's total in-flight replica count plus the planner's
    proactive ``budget`` set-point (min <= budget <= max)."""
    min_replicas: int
    max_replicas: int
    budget: int

    def __post_init__(self):
        if not (0 <= self.min_replicas <= self.budget <= self.max_replicas):
            raise ValueError(
                f"bad lease min={self.min_replicas} budget={self.budget} "
                f"max={self.max_replicas}")

    def astuple(self) -> tuple:
        return (self.min_replicas, self.max_replicas, self.budget)


class CellController:
    """Per-cell reactive autoscaler: acts EVERY tick on the cell's own
    live signals, bounded by the current lease. Decentralized by
    construction — it reads nothing global and keeps working when the
    global plane is dark.

    Rule (k8s-style with patience): utilization above ``hi`` (or queue
    exceeding ``surge`` ticks of capacity) for ``patience`` consecutive
    ticks adds one replica; utilization below ``lo`` with an empty queue
    for ``patience`` ticks removes one; ``cooldown`` ticks separate
    actions. Targets clamp into the lease before they reach the backend
    (which clamps again — the lease is enforced twice by design)."""

    def __init__(self, backend: MultiCellBackend, cell_index: int, *,
                 hi: float = 0.85, lo: float = 0.25, surge: float = 2.0,
                 patience: int = 2, cooldown: int = 2):
        self.backend = backend
        self.c = int(cell_index)
        self.hi = float(hi)
        self.lo = float(lo)
        self.surge = float(surge)
        self.patience = int(patience)
        self.cooldown = int(cooldown)
        self.lease: Optional[CellLease] = None
        self.actions = 0              # total local scale actions taken
        self.up_actions = 0
        self._over = 0
        self._under = 0
        self._last_action = -(10 ** 9)
        self.action_ticks: list = []  # backend tick of each action (stats)

    def grant(self, lease: CellLease) -> None:
        """Install a new lease: bounds land on the cell backend itself and
        the current replica count is pulled into range immediately (a
        shrunken lease takes effect now, not at the next pressure
        change)."""
        self.lease = lease
        cell = self.backend.cells[self.c]
        cell.set_lease(lease.min_replicas, lease.max_replicas)
        cur = self.backend.cell_in_flight(self.c)
        if cur < lease.min_replicas or cur > lease.max_replicas:
            tgt = int(np.clip(cur, lease.min_replicas, lease.max_replicas))
            self.backend.scale_cell(self.c, tgt)

    def _signals(self) -> tuple:
        """(utilization proxy, queue, capacity) from LIVE cell state."""
        cell = self.backend.cells[self.c]
        if self.backend._elastic[self.c]:
            q = float(cell.queue_depths().sum())
            cap = float(cell.request_capacity().sum())
        else:
            q = float(cell.state.queue.sum())
            cap = float(cell.capacity().sum()) * self.backend.tick_seconds
        m = self.backend._live_m[self.c]
        util = float(m.get("mean_utilization", 0.0)) if m else 0.0
        return util, q, cap

    def step(self) -> None:
        """One local control tick. No-op without a lease (centralized
        mode) or while the cell is blacked out."""
        if self.lease is None or not self.backend._alive[self.c]:
            self._over = self._under = 0
            return
        util, q, cap = self._signals()
        hot = util > self.hi or (cap > 1e-9 and q > self.surge * cap) \
            or (cap <= 1e-9 and q > 0.0)
        cold = util < self.lo and q <= 0.0
        self._over = self._over + 1 if hot else 0
        self._under = self._under + 1 if cold else 0
        t = self.backend.t
        if t - self._last_action < self.cooldown:
            return
        cur = self.backend.cell_in_flight(self.c)
        tgt = cur
        if self._over >= self.patience and cur < self.lease.max_replicas:
            tgt = cur + 1
        elif self._under >= self.patience and cur > self.lease.min_replicas:
            tgt = cur - 1
        if tgt == cur:
            return
        self.backend.scale_cell(self.c, tgt)
        self._last_action = t
        self._over = self._under = 0
        self.actions += 1
        if tgt > cur:
            self.up_actions += 1
        self.action_ticks.append(t)
        self.backend.note_local_action()


class GlobalPlanner:
    """Cross-cell lease planner: a pure function of the router's views —
    deterministic, stateless, safe to re-run from a checkpoint.

    Demand per cell = last-known queue + in-flight work, discounted by
    ``confidence_decay ** staleness`` (a dark cell's demand estimate is
    old) and by ``1 - risk`` (a doomed cell should not be granted budget
    it is about to lose). Budgets split ``total_budget`` proportionally
    (every alive cell keeps at least ``min_per_cell``); the lease opens
    ``lease_slack`` headroom above and below the budget so the local
    controllers can react without waiting for the next global plan."""

    def __init__(self, n_cells: int, *, total_budget: int,
                 max_per_cell: int, min_per_cell: int = 1,
                 lease_slack: float = 0.5, confidence_decay: float = 0.6):
        if total_budget < n_cells * min_per_cell:
            raise ValueError(
                f"total_budget {total_budget} cannot cover "
                f"{n_cells} cells x min {min_per_cell}")
        self.n_cells = int(n_cells)
        self.total_budget = int(total_budget)
        self.max_per_cell = int(max_per_cell)
        self.min_per_cell = int(min_per_cell)
        self.lease_slack = float(lease_slack)
        self.confidence_decay = float(confidence_decay)

    def plan(self, views: list, alive: np.ndarray,
             in_flight: np.ndarray) -> list:
        """One lease per cell (dead cells get an empty [0, 0] lease)."""
        demand = np.zeros(self.n_cells, np.float64)
        for c, v in enumerate(views):
            if not alive[c]:
                continue
            d = max(v.snap.get("queue", 0.0), 0.0) + max(int(in_flight[c]),
                                                         1)
            conf = self.confidence_decay ** v.staleness
            risk = float(np.clip(v.snap.get("risk", 0.0), 0.0, 1.0))
            demand[c] = d * conf * (1.0 - 0.8 * risk) + 1e-9
        total = demand.sum()
        leases = []
        for c in range(self.n_cells):
            if not alive[c] or total <= 0.0:
                leases.append(CellLease(0, 0, 0))
                continue
            budget = int(round(self.total_budget * demand[c] / total))
            budget = int(np.clip(budget, self.min_per_cell,
                                 self.max_per_cell))
            hi = int(np.clip(int(np.ceil(budget * (1.0 + self.lease_slack))),
                             budget, self.max_per_cell))
            lo = int(np.clip(int(np.floor(budget *
                                          (1.0 - self.lease_slack))),
                             0, budget))
            lo = max(lo, min(self.min_per_cell, budget))
            leases.append(CellLease(lo, hi, budget))
        return leases


class PlaneSupervisor:
    """Owns the global control tick and makes the global plane
    crash-tolerant. See module docstring for the full contract.

    ``plane`` is an optional ``ControlPlane`` (forecast + balance;
    construct it with ``scaler='none'`` — scaling authority belongs to
    the leases). With ``plane=None`` the supervisor runs the pure
    decentralized loop: backend tick + local controllers + lease plans.
    """

    def __init__(self, backend: MultiCellBackend, planner: GlobalPlanner,
                 controllers: list, *, plane=None, plan_interval: int = 10,
                 apply_budget: bool = True):
        self.backend = backend
        self.planner = planner
        self.controllers = list(controllers)
        self.plane = plane
        self.plan_interval = max(1, int(plan_interval))
        self.apply_budget = apply_budget
        self.leases: list = [None] * backend.n_cells
        self.plan_log: list = []      # (tick, [lease tuples]) per grant
        self.outage_steps = 0         # steps run with the plane dark
        self.restores = 0             # down->up reconciliations observed
        self._last_plan: Optional[int] = None
        self._saw_down = False

    # -------------------------------------------------- checkpoint/restore
    def checkpoint(self) -> dict:
        """Everything a restarted global-plane process needs: planner
        config is immutable, so the checkpoint is the lease state, the
        plan cadence phase, and the ``ControlPlane`` decision state.
        Cheap enough to take every plan interval."""
        return {
            "last_plan": self._last_plan,
            "leases": [lease.astuple() if lease is not None else None
                       for lease in self.leases],
            # controller DECISION state (patience counters + cooldown
            # clock) — stats counters reset with the process, but the
            # reactive rule must resume mid-stride for the restored run
            # to continue the exact decision stream
            "controllers": [(ctl._over, ctl._under, ctl._last_action)
                            for ctl in self.controllers],
            "plane": self.plane.state_dict() if self.plane is not None
            else None,
        }

    def restore(self, state: dict) -> None:
        """Load a checkpoint into this (possibly freshly constructed)
        supervisor. Pure state reinstatement — leases re-install their
        bounds on the cells (idempotent), but NO scale targets are
        replayed: current replica counts are live cell state the crashed
        plane has no authority to rewind. Reconciliation against live
        state happens on the next ``step`` via the normal down→up
        transition (or the plan cadence, if no outage happened)."""
        self._last_plan = state["last_plan"]
        self.leases = [CellLease(*t) if t is not None else None
                       for t in state["leases"]]
        for ctl, lease in zip(self.controllers, self.leases):
            ctl.lease = lease
            if lease is not None:
                self.backend.cells[ctl.c].set_lease(lease.min_replicas,
                                                    lease.max_replicas)
        for ctl, cs in zip(self.controllers,
                           state.get("controllers") or []):
            ctl._over, ctl._under, ctl._last_action = cs
        if self.plane is not None and state.get("plane") is not None:
            self.plane.load_state_dict(state["plane"])

    # --------------------------------------------------------------- plan
    def _grant(self, leases: list) -> None:
        self.leases = list(leases)
        for ctl, lease in zip(self.controllers, self.leases):
            if lease.max_replicas <= 0 and lease.min_replicas <= 0 \
                    and not self.backend._alive[ctl.c]:
                ctl.lease = None       # dead cell: nothing to control
                continue
            ctl.grant(lease)
            if self.apply_budget:
                # the proactive half: steer toward the planner's set-point
                # (the reactive controllers correct from there)
                self.backend.scale_cell(ctl.c, lease.budget)

    def _plan_now(self) -> None:
        in_flight = np.asarray(
            [self.backend.cell_in_flight(c)
             for c in range(self.backend.n_cells)], np.int64)
        leases = self.planner.plan(self.backend.views, self.backend._alive,
                                   in_flight)
        self._grant(leases)
        self._last_plan = self.backend.t
        self.plan_log.append(
            (self.backend.t, [lease.astuple() for lease in leases]))

    # --------------------------------------------------------------- tick
    def step(self, arrival_rate: float = 0.0) -> dict:
        """One global tick: plane work only while alive, local control
        always."""
        alive_before = self.backend.plane_alive
        if alive_before and self._saw_down:
            # down -> up observed: the restarted plane reconciles against
            # live cell state with a FRESH plan (never a replay of the
            # pre-crash targets)
            self._saw_down = False
            self.restores += 1
            self._last_plan = None
        if alive_before:
            if self.plane is not None:
                m = self.plane.step(arrival_rate)
            else:
                m = self.backend.tick(arrival_rate)
            # a crash landing inside THIS tick suppresses the grant too
            # (the plane that would sign it is already gone)
            if self.backend.plane_alive and (
                    self._last_plan is None
                    or self.backend.t - self._last_plan
                    >= self.plan_interval):
                self._plan_now()
        else:
            # plane dark: tick the data plane directly — no observation,
            # no balancing, no lease changes. Router weights ride the
            # confidence-decay/capacity fallback inside the backend.
            m = self.backend.tick(arrival_rate)
            self.outage_steps += 1
        if not self.backend.plane_alive:
            self._saw_down = True
        for ctl in self.controllers:
            ctl.step()
        return m

    # ------------------------------------------------------------- report
    def local_actions(self) -> int:
        return sum(ctl.actions for ctl in self.controllers)

    def summary(self) -> dict:
        return {
            "plans": len(self.plan_log),
            "local_actions": self.local_actions(),
            "local_up_actions": sum(c.up_actions for c in self.controllers),
            "outage_steps": int(self.outage_steps),
            "restores": int(self.restores),
            "leases": [lease.astuple() if lease is not None else None
                       for lease in self.leases],
        }
