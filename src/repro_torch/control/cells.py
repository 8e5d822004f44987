"""Multi-cell fault-tolerant routing plane: ``CellRouter`` + ``MultiCellBackend``
(the port of ``repro.control.cells``).

The paper's decentralization claim ("decentralised decision-making ...
enhances fault tolerance") needs a plane that is not a single synchronous
brain over one cluster. This module treats N existing backends -- fluid
``ClusterSim`` or request-level ``ElasticClusterFrontend``, mixed -- as
*cells* behind one federated ``ClusterBackend``: the unchanged
``ControlPlane`` drives the federation exactly like a single cluster
(``num_nodes`` = number of cells, ``scale_to`` targets are per-cell replica
totals), while the router handles the intra-federation placement of every
request. Three failure classes are survived end-to-end:

  * **cell blackout** (``cell_down@t:cC`` / ``cell_up@t:cC`` in
    ``ChaosSchedule``): the dead cell's entire queue + in-flight work is
    evacuated through the frontend's ledger-safe path (``blackout()`` on
    the cell; a fluid cell hands back its backlog's work mass instead) and
    re-routed to siblings in arrival order. Exactly-once accounting is
    lifted to ONE global ``RequestLedger`` shared by every elastic cell, so
    ``double_served == 0`` holds *across* cells: a request that dies in
    cell A and finishes in cell B is still a single rid with a single
    terminal state.
  * **control-plane partition** (``partition@t:cC[:kK]`` / ``heal@t:cC``):
    a cell keeps serving but its metrics feed goes dark. The router keeps a
    per-cell ``MetricsView`` with a staleness clock; a stale cell's learned
    routing fraction is replaced by a reactive weighted-capacity estimate
    (last-known capacity) whose confidence decays geometrically with
    staleness, and a cell whose view exceeds ``max_staleness`` is
    hard-quarantined (no traffic, ``up_mask`` 0) until the feed heals —
    the decentralized-fallback design of ``core/decentralized.py``: keep
    making *safe* local decisions when consensus signals are missing.
  * **total overload**: when EVERY healthy cell's tier-weighted pressure
    per unit capacity exceeds ``shed_threshold``, the router degrades
    gracefully — admission-sheds the lowest-priority tiers first (never
    the top tier), each shed request landing in the explicit ``shed``
    ledger terminal (retryable, never silent loss). Queues stay bounded
    instead of collapsing under the flash crowd.
  * **global-plane outage** (``plane_down@t[:kK]`` / ``plane_up@t``):
    the whole global control plane — planner, balancer, metrics
    pipeline — goes dark at once. EVERY cell's feed ages together
    (``plane_staleness`` counts the dark ticks) and the router rides the
    same confidence-decayed capacity-weight fallback as a partition, but
    plane-caused staleness never *quarantines* a cell: quarantine exists
    to protect against one dark cell among fresh siblings, and when all
    views age in lockstep the safe local decision is capacity-weighted
    routing, not parking the federation. Cells keep serving AND — under
    the two-level hierarchy (``control/hierarchy.py``) — keep autoscaling
    inside their last granted capacity lease; the global planner's
    actions are suppressed until ``plane_up``, when the restarted plane
    reconciles from its checkpoint against live cell state
    (``PlaneSupervisor.restore``) without double-applying scale actions.

**Lease contract**: a capacity lease is a per-cell
``[min_replicas, max_replicas]`` bound on the cell's TOTAL in-flight
replica count, granted by the hierarchy's ``GlobalPlanner`` and enforced
by the cell backends themselves (``set_lease`` on
``ElasticClusterFrontend`` / ``ClusterSim`` clamps every ``scale_to``) —
so both the local ``CellController`` and a restored global plane
replaying a stale plan are bounded by the same authority. During an
outage the LAST granted lease stays in force: local reactive scaling
continues inside it at full tick rate (the paper's decentralization
claim), and nothing can exceed the budget the dead planner granted.

Routing is additionally biased away from *doomed* cells before a blackout
lands: per-node ``preempt_risk`` aggregates to a per-cell risk score and
multiplies the cell's weight by ``(1 - risk_bias * risk)``.

Single-cell parity: with one healthy cell the router forwards every
request in submit order, overrides nothing the cell would not compute
itself, and issues zero extra device work — syncs and decode dispatches
per tick are identical to driving the frontend directly (asserted in
``tests/test_cells.py``).

Clients (``workload.clients.ClientPool``) submit to the *router*, not a
cell: ``MultiCellBackend`` exposes the same frontend facade
(``alloc_rid`` / ``submit`` / ``abandon`` / ``ledger`` / ``t`` /
``run_until_drained``) so the pool is reused unchanged.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

from repro_torch.serving.elastic import (ChaosSchedule, RequestLedger,
                                         _requeue_merged)
from repro_torch.serving.engine import Request, normalize_fractions
from repro_torch.workload.trace import DEFAULT_TIERS, TierSet

_INDEFINITE = -1          # partition with no :k — lasts until heal@t:cC


class MetricsView:
    """Last-known view of one cell: derived scalars (``snap``) + the full
    metrics dict of the last *observed* tick, plus the staleness clock the
    router's confidence decay and quarantine rule run on. ``staleness`` is
    the number of ticks since the feed last delivered (0 = fresh)."""

    def __init__(self, snap: dict, metrics: dict):
        self.snap = snap
        self.metrics = metrics
        self.staleness = 0

    def update(self, snap: dict, metrics: dict) -> None:
        self.snap = snap
        self.metrics = metrics
        self.staleness = 0

    def age(self) -> None:
        """The feed did not deliver this tick (partition or blackout)."""
        self.staleness += 1

    def quarantined(self, max_staleness: int) -> bool:
        return self.staleness > max_staleness


class CellRouter:
    """Pure routing policy over per-cell views (no cluster state of its
    own — everything it knows arrives as ``MetricsView``s + the alive
    mask, so it degrades exactly as its information degrades).

    ``weights``: start from the control plane's learned per-cell fractions;
    for any stale cell, fall back to a reactive weighted-capacity share
    (last-known capacity over the healthy total) times a confidence factor
    ``confidence_decay ** staleness``; zero out dead and quarantined cells;
    bias every cell by ``1 - risk_bias * cell_risk``; renormalize. An
    all-dead federation yields all-zero weights (uniform-over-none) — the
    backend parks arrivals instead of routing them.

    ``shed_tiers``: tier names to admission-shed this tick. Sheds only
    when EVERY healthy cell's tier-weighted pressure per unit capacity
    exceeds ``shed_threshold`` (if one cell has room, route there instead),
    escalating one priority tier per threshold multiple, lowest first —
    the top tier is never shed (single-tier federations never shed)."""

    def __init__(self, n_cells: int, *, tiers: Optional[TierSet] = None,
                 max_staleness: int = 4, confidence_decay: float = 0.6,
                 risk_bias: float = 0.8,
                 shed_threshold: Optional[float] = None,
                 adaptive: bool = True):
        self.n_cells = int(n_cells)
        self.tiers = tiers or DEFAULT_TIERS
        self.max_staleness = int(max_staleness)
        self.confidence_decay = float(confidence_decay)
        self.risk_bias = float(risk_bias)
        self.shed_threshold = shed_threshold
        self.adaptive = adaptive      # False = static split (the A/B arm)

    def healthy(self, views: list, alive: np.ndarray,
                plane_staleness: int = 0) -> np.ndarray:
        """Alive and not quarantined. ``plane_staleness`` is subtracted
        from each view's clock before the quarantine check: staleness the
        whole federation shares (global plane down) is not evidence that
        ONE cell is dark — quarantining everything would park all traffic
        during an outage the cells themselves are healthy through."""
        return np.asarray(
            [bool(alive[c]) and max(
                views[c].staleness - int(plane_staleness), 0)
                <= self.max_staleness
             for c in range(len(views))], bool)

    def weights(self, fractions: np.ndarray, views: list,
                alive: np.ndarray, plane_staleness: int = 0) -> np.ndarray:
        c_n = len(views)
        if not self.adaptive:
            # routing disabled: a fixed uniform split that ignores health,
            # staleness and risk — the ablation baseline the bench A/Bs
            return np.full(c_n, 1.0 / c_n, np.float64)
        healthy = self.healthy(views, alive, plane_staleness)
        cap = np.asarray([max(v.snap.get("capacity", 0.0), 0.0)
                          for v in views], np.float64)
        total_cap = max(cap[healthy].sum(), 1e-9) if healthy.any() else 1e-9
        w = np.asarray(fractions, np.float64).copy() \
            if fractions is not None and len(fractions) == c_n \
            else np.full(c_n, 1.0 / c_n, np.float64)
        for c, v in enumerate(views):
            if v.staleness > 0:
                # stale view: the learned fraction was computed from data
                # this old too — replace with the reactive rule, confidence-
                # decayed so fresher siblings absorb the difference
                conf = self.confidence_decay ** v.staleness
                w[c] = (cap[c] / total_cap) * conf
        risk = np.asarray([np.clip(v.snap.get("risk", 0.0), 0.0, 1.0)
                           for v in views], np.float64)
        w = w * np.clip(1.0 - self.risk_bias * risk, 0.0, 1.0)
        return normalize_fractions(w, mask=healthy.astype(np.float64))

    def shed_tiers(self, views: list, alive: np.ndarray,
                   plane_staleness: int = 0) -> frozenset:
        if self.shed_threshold is None or len(self.tiers) <= 1 \
                or not self.adaptive:
            return frozenset()
        healthy = self.healthy(views, alive, plane_staleness)
        if not healthy.any():
            return frozenset()        # full blackout: park, don't shed
        ppc = [views[c].snap.get("pressure", 0.0)
               / max(views[c].snap.get("capacity", 0.0), 1e-9)
               for c in range(len(views)) if healthy[c]]
        x = min(ppc)
        if x <= self.shed_threshold:
            return frozenset()
        level = min(int(x / self.shed_threshold), len(self.tiers) - 1)
        order = self.tiers.priority   # high priority first
        return frozenset(self.tiers.names[i] for i in order[-level:])


class MultiCellBackend:
    """A federation of cells behind the single-cluster ``ClusterBackend``
    protocol (``num_nodes`` = number of cells) plus the frontend facade
    closed-loop clients need. See module docstring for the failure model.

    ``cells`` mixes ``ElasticClusterFrontend`` (request-level) and
    ``ClusterSim`` (fluid) instances. Elastic cells share ONE global
    ``RequestLedger`` (theirs is replaced) and always tick with zero
    open-loop arrival rate — the router owns rid allocation and arrival
    generation, so per-cell counters can never collide in the shared
    ledger. Fluid cells receive their routed share of the arrival-rate
    mass. Intra-cell placement is reactive weighted-capacity over the
    cell's own (locally fresh) node state — the decentralized half of the
    design: a partition starves the *global* view, never the local one."""

    def __init__(self, cells: list, *, tiers: Optional[TierSet] = None,
                 router: Optional[CellRouter] = None,
                 chaos: Optional[ChaosSchedule] = None,
                 request_factory=None, tick_seconds: float = 1.0,
                 max_queue: Optional[int] = None, seed: int = 0,
                 ledger: Optional[RequestLedger] = None):
        if not cells:
            raise ValueError("MultiCellBackend needs at least one cell")
        self.cells = list(cells)
        self.n_cells = len(self.cells)
        self.num_nodes = self.n_cells          # the plane sees cells as nodes
        self.tiers = tiers or DEFAULT_TIERS
        self.router = router or CellRouter(self.n_cells, tiers=self.tiers)
        self.chaos = chaos
        self.request_factory = request_factory
        self.tick_seconds = float(tick_seconds)
        self.max_queue = max_queue
        self.rng = np.random.default_rng(seed)
        self.ledger = RequestLedger() if ledger is None else ledger
        self._elastic = [self._is_elastic(c) for c in self.cells]
        for cell, el in zip(self.cells, self._elastic):
            if el:
                cell.ledger = self.ledger      # ONE ledger across the fleet
        self.t = 0
        self._req_id = 0
        self._acc = 0.0
        self.pending: deque = deque()          # global routable pool
        self.culled: list = []                 # expired before any cell
        self._alive = np.ones(self.n_cells, bool)
        self._partition = np.zeros(self.n_cells, np.int64)  # ticks left
        self._fractions = np.full(self.n_cells, 1.0 / self.n_cells,
                                  np.float64)
        self._weights = self._fractions.copy()
        self._shed_now: frozenset = frozenset()
        self.shed_total = 0
        self._shed_reported = 0
        self._culled_reported = 0
        self.evacuated_total = 0
        self.cell_downs = 0
        self.quarantine_ticks = 0
        # global-plane liveness: 0 = up, >0 = ticks of outage left,
        # _INDEFINITE = down until an explicit plane_up. While down, every
        # view ages together and plane_staleness counts the dark ticks.
        self._plane_left = 0
        self._plane_stale = 0
        self.plane_outages = 0
        self.plane_outage_ticks = 0
        # hierarchy bookkeeping: CellControllers report their scale actions
        # here (note_local_action) so the federation metrics expose them
        self._local_actions_acc = 0
        self.local_actions_total = 0
        self._fluid_backlog = 0.0              # evacuated fluid work mass
        self._live_m: list = [{} for _ in self.cells]
        self.views = [MetricsView(*self._snapshot(c))
                      for c in range(self.n_cells)]
        self._m: dict = {}

    # ------------------------------------------------------------- plumbing
    @staticmethod
    def _is_elastic(cell) -> bool:
        return hasattr(cell, "submit") and hasattr(cell, "nodes")

    def _snapshot(self, c: int) -> tuple:
        """Fresh derived scalars + metrics dict for cell ``c`` (what the
        feed would deliver this tick). Only called when the feed is up."""
        cell = self.cells[c]
        m = self._live_m[c]
        if self._elastic[c]:
            q = float(cell.queue_depths().sum())
            cap = float(cell.request_capacity().sum())
            tiered = len(cell.tiers) > 1
            press = float(cell.tiers.pressure(cell.tier_depths()).sum()) \
                if tiered else q
            snap = {
                "queue": q, "capacity": cap, "pressure": press,
                "risk": float(cell.preempt_risk().mean()),
                "in_flight": int(cell.in_flight().sum()),
                "active": int(sum(len(n.live) for n in cell.nodes)),
                "speed": float(np.mean(cell.node_speed)),
                "util": float(m.get("mean_utilization", 0.0)),
            }
        else:
            s = cell.state
            q = float(s.queue.sum())
            cap = float(cell.capacity().sum()) * self.tick_seconds
            press = float(cell.tiers.pressure(cell.tier_queue).sum()) \
                if cell.tier_queue is not None else q
            snap = {
                "queue": q, "capacity": cap, "pressure": press,
                "risk": float(cell.preempt_risk().mean()),
                "in_flight": int((s.active + s.pending.sum(axis=1)).sum()),
                "active": int(s.active.sum()),
                "speed": float(np.mean(cell.node_speed)),
                "util": float(m.get("mean_utilization", 0.0)),
            }
        return snap, m

    def _elastic_cells(self):
        return [c for c in range(self.n_cells) if self._elastic[c]]

    def _outstanding(self) -> int:
        out = len(self.pending)
        for c in self._elastic_cells():
            out += self.cells[c]._outstanding()
        return out

    # ----------------------------------------------------- frontend facade
    def alloc_rid(self) -> int:
        rid = self._req_id
        self._req_id += 1
        return rid

    def submit(self, req: Request) -> bool:
        """Router-level submit (clients talk to the federation, not a
        cell). Duplicate suppression and admission shedding both happen
        HERE — a request never reaches a cell unless it is the rid's only
        live attempt and its tier is currently admitted."""
        if not any(self._elastic):
            raise RuntimeError(
                "submit() needs at least one request-level (elastic) cell")
        if req.arrival == 0.0:
            req.arrival = float(self.t)
        if not self.ledger.register(req):
            return False
        if self.max_queue is not None \
                and self._outstanding() >= self.max_queue:
            self.ledger.reject(req)
            return False
        if req.tier in self._shed_now:
            self.ledger.shed(req)
            self.shed_total += 1
            return False
        self.pending.append(req)
        return True

    def abandon(self, rid: int) -> bool:
        return self.ledger.abandon(rid)

    @property
    def finished(self) -> list:
        """All completions across the federation + router-level culls."""
        out = list(self.culled)
        for c in self._elastic_cells():
            out.extend(self.cells[c].finished)
        return out

    # fleet-stat aggregation over the elastic cells, so callers report a
    # federation exactly like a single frontend (``launch.serve``)
    def _sum_attr(self, name: str) -> int:
        return sum(getattr(self.cells[c], name)
                   for c in self._elastic_cells())

    def _sum_call(self, name: str):
        return sum(getattr(self.cells[c], name)()
                   for c in self._elastic_cells())

    @property
    def replicas_spawned(self) -> int:
        return self._sum_attr("replicas_spawned")

    @property
    def failed_replicas(self) -> int:
        return self._sum_attr("failed_replicas")

    @property
    def replica_ticks(self) -> int:
        return self._sum_attr("replica_ticks")

    @property
    def preempted_nodes(self) -> int:
        return self._sum_attr("preempted_nodes")

    @property
    def preempted_replicas(self) -> int:
        return self._sum_attr("preempted_replicas")

    def decode_dispatches(self) -> int:
        return self._sum_call("decode_dispatches")

    def decode_steps(self) -> int:
        return self._sum_call("decode_steps")

    def prefill_dispatches(self) -> int:
        return self._sum_call("prefill_dispatches")

    def sync_count(self) -> int:
        return self._sum_call("sync_count")

    def sync_wait_s(self) -> float:
        return float(self._sum_call("sync_wait_s"))

    def prefill_retraces(self) -> int:
        return self._sum_call("prefill_retraces")

    # -------------------------------------------------------- cell lifecycle
    def _check_cell(self, c: int):
        if not isinstance(c, (int, np.integer)) \
                or not 0 <= c < self.n_cells:
            raise ValueError(
                f"cell index {c!r} out of range for {self.n_cells} cells")

    def cell_down(self, c: int) -> None:
        """Blackout cell ``c``: evacuate everything it holds through the
        ledger-safe path and merge it back into the global pool in arrival
        order for re-routing (fluid cells return work *mass* instead)."""
        self._check_cell(c)
        if not self._alive[c]:
            raise ValueError(f"cell c{c} is already down")
        self._alive[c] = False
        self.cell_downs += 1
        if self._elastic[c]:
            evac = self.cells[c].blackout()
            self.evacuated_total += len(evac)
            _requeue_merged(self.pending, evac)
        else:
            self._fluid_backlog += self.cells[c].blackout()

    def cell_up(self, c: int) -> None:
        """Restore cell ``c`` (capacity returns through provisioning)."""
        self._check_cell(c)
        if self._alive[c]:
            raise ValueError(f"cell c{c} is not down")
        self.cells[c].restore()
        self._alive[c] = True

    # ------------------------------------------------------ plane lifecycle
    @property
    def plane_alive(self) -> bool:
        return self._plane_left == 0

    def plane_down(self, ticks: Optional[int] = None) -> None:
        """Crash the global control plane: from this tick until restore the
        metrics feed of EVERY cell goes dark together (views age,
        ``plane_staleness`` climbs) and any driver honoring the contract
        suppresses global planning/balancing/scaling. ``ticks`` bounds the
        outage (``plane_down@t:kK``); ``None`` lasts until ``plane_up``."""
        if self._plane_left != 0:
            raise ValueError("global plane is already down")
        self._plane_left = _INDEFINITE if ticks is None else int(ticks)
        if self._plane_left == 0:     # k0 is a no-op crash, not an error
            return
        self.plane_outages += 1

    def plane_up(self) -> None:
        """Restart the global plane: feeds refresh on the next tick and
        ``plane_staleness`` resets. The hierarchy's ``PlaneSupervisor``
        observes the transition and reconciles from its checkpoint."""
        if self._plane_left == 0:
            raise ValueError("global plane is not down")
        self._plane_left = 0

    def note_local_action(self, n: int = 1) -> None:
        """CellControllers report local scale actions for the federation's
        ``local_actions`` metric (and the cumulative total)."""
        self._local_actions_acc += int(n)
        self.local_actions_total += int(n)

    def _advance_chaos(self):
        if self.chaos is None:
            return
        for kind, c, arg in self.chaos.pop(self.t):
            if kind in ChaosSchedule.PLANE_KINDS:
                if kind == "plane_down":
                    self.plane_down(arg)
                else:
                    self.plane_up()
                continue
            if kind not in ChaosSchedule.CELL_KINDS:
                continue              # node-kind events belong to the cells
            self._check_cell(c)
            if kind == "cell_down":
                self.cell_down(c)
            elif kind == "cell_up":
                self.cell_up(c)
            elif kind == "partition":
                self._partition[c] = _INDEFINITE if arg is None else int(arg)
            else:                     # heal
                self._partition[c] = 0

    # ------------------------------------------------------------- arrivals
    def _generate_arrivals(self, arrival_rate: float, w: np.ndarray):
        """Open-loop arrivals: the elastic cells' combined routing share
        becomes discrete requests (router-owned rids); fluid cells consume
        their share as rate mass inside their own tick."""
        if self.request_factory is None or arrival_rate <= 0.0:
            return
        e_share = float(sum(w[c] for c in self._elastic_cells()))
        self._acc += arrival_rate * self.tick_seconds * e_share
        n = int(self._acc)
        self._acc -= n
        for _ in range(n):
            req = self.request_factory(self._req_id, self.t)
            self._req_id += 1
            req.arrival = float(self.t - 1)
            self.ledger.register(req)
            self.pending.append(req)

    def _distribute(self, w: np.ndarray, shed: frozenset):
        """Place the global pool: cull expired, shed overloaded tiers,
        route the rest to elastic cells ∝ weight. Zero total weight over
        elastic cells (full blackout) parks everything — the retry-pool
        semantics of the all-false-mask rule."""
        eidx = self._elastic_cells()
        we = np.asarray([w[c] for c in eidx], np.float64)
        s = we.sum()
        routable = s > 1e-12
        if routable:
            we = we / s
        hold: deque = deque()
        while self.pending:
            req = self.pending.popleft()
            if req.out_of_time(self.t):
                req.finish_time = float(self.t)
                self.ledger.resolve(req)
                self.culled.append(req)
            elif req.tier in shed:
                self.ledger.shed(req)
                self.shed_total += 1
            elif not routable:
                hold.append(req)
            else:
                if len(eidx) == 1:
                    c = eidx[0]       # no rng draw: single-cell parity
                else:
                    c = eidx[int(self.rng.choice(len(eidx), p=we))]
                self.cells[c].pending.append(req)
        self.pending = hold

    # ------------------------------------------------- ClusterBackend API
    def up_mask(self) -> np.ndarray:
        return self.router.healthy(self.views, self._alive,
                                   self._plane_stale).astype(np.float32)

    def queue_depths(self) -> np.ndarray:
        return np.asarray([v.snap["queue"] for v in self.views], np.float32)

    def capacity(self) -> np.ndarray:
        return np.asarray([v.snap["capacity"] for v in self.views],
                          np.float32)

    def in_flight(self) -> np.ndarray:
        return np.asarray([v.snap["in_flight"] for v in self.views],
                          np.int32)

    @property
    def node_speed(self) -> np.ndarray:
        return np.asarray([v.snap["speed"] for v in self.views], np.float32)

    def preempt_risk(self) -> np.ndarray:
        """Per-cell aggregated risk (mean of the cell's per-node 0/1)."""
        return np.asarray([v.snap["risk"] for v in self.views], np.float32)

    def cell_staleness(self) -> np.ndarray:
        return np.asarray([v.staleness for v in self.views], np.float32)

    def observe(self, forecast: np.ndarray) -> np.ndarray:
        """Same Eq.1-3 feature layout as the single-cell backends, one row
        per CELL, built from the views — the plane honestly observes stale
        data for partitioned cells, never a side channel."""
        q = self.queue_depths()
        cap = self.capacity()
        load = q / max(q.sum(), 1.0)
        util_proxy = np.minimum(q / np.maximum(cap, 1e-9), 4.0) / 4.0
        capn = cap / max(cap.sum(), 1e-9)
        up = self.up_mask()
        f = np.broadcast_to(forecast[None, :],
                            (self.n_cells, forecast.shape[0]))
        obs = np.concatenate([load[:, None], util_proxy[:, None],
                              capn[:, None], up[:, None], f], axis=1)
        return obs.astype(np.float32)

    def route(self, fractions: np.ndarray) -> None:
        self._fractions = np.asarray(fractions, np.float64)

    def metrics(self) -> dict:
        return self._m

    def scale_to(self, target: np.ndarray) -> None:
        """Per-cell replica totals, split evenly across each cell's
        schedulable nodes (dead / doomed nodes and dead cells skipped).
        Cells under a capacity lease clamp their own total
        (``set_lease``)."""
        target = np.asarray(target)
        for c in range(self.n_cells):
            self.scale_cell(c, int(target[c]))

    def scale_cell(self, c: int, tgt: int) -> None:
        """Scale ONE cell to a total replica count (the hierarchy's
        ``CellController`` entry point: local actions touch only their own
        cell). Splits evenly across the cell's schedulable nodes; the
        cell's own lease clamp applies."""
        self._check_cell(c)
        if not self._alive[c]:
            return
        cell = self.cells[c]
        tgt = max(int(tgt), 0)
        if tgt == self.cell_in_flight(c):
            return                     # no total change: never reshuffle
        if self._elastic[c]:
            ok = [i for i, nd in enumerate(cell.nodes)
                  if not nd.down and nd.preempt_left < 0]
            if not ok:
                return
            per = np.zeros(cell.num_nodes, np.int32)
            base, rem = divmod(tgt, len(ok))
            for j, i in enumerate(ok):
                per[i] = base + (1 if j < rem else 0)
            cell.scale_to(per)
        else:
            s = cell.state
            ok = [i for i in range(cell.cfg.num_nodes)
                  if not cell._preempt_down[i] and s.notice_left[i] < 0]
            if not ok:
                return
            per = (s.active + s.pending.sum(axis=1)).copy()
            base, rem = divmod(tgt, len(ok))
            for j, i in enumerate(ok):
                per[i] = base + (1 if j < rem else 0)
            cell.scale_to(per)

    def cell_in_flight(self, c: int) -> int:
        """Live total in-flight replicas of ONE cell (local, never stale —
        what a CellController may legitimately observe at tick rate)."""
        self._check_cell(c)
        cell = self.cells[c]
        if self._elastic[c]:
            return int(cell.in_flight().sum())
        s = cell.state
        return int((s.active + s.pending.sum(axis=1)).sum())

    # ---------------------------------------------------------------- tick
    def tick(self, arrival_rate: float = 0.0) -> dict:
        self.t += 1
        self._advance_chaos()
        w = self.router.weights(self._fractions, self.views, self._alive,
                                self._plane_stale)
        self._weights = w
        self._shed_now = shed = self.router.shed_tiers(
            self.views, self._alive, self._plane_stale)
        self._generate_arrivals(arrival_rate, w)
        self._distribute(w, shed)
        # fluid share: routed rate mass + re-injected evacuated backlog
        fidx = [c for c in range(self.n_cells) if not self._elastic[c]]
        fluid_extra = np.zeros(self.n_cells, np.float64)
        if fidx and self._fluid_backlog > 0.0:
            wf = np.asarray([w[c] for c in fidx], np.float64)
            if wf.sum() > 1e-12:
                share = wf / wf.sum()
                for j, c in enumerate(fidx):
                    fluid_extra[c] = self._fluid_backlog * share[j] \
                        / max(self.tick_seconds, 1e-9)
                self._fluid_backlog = 0.0
        # a dark plane ages EVERY feed together (plane_staleness), on top
        # of any per-cell partition still running its own clock
        plane_dark = self._plane_left != 0
        if plane_dark:
            self._plane_stale += 1
            self.plane_outage_ticks += 1
            if self._plane_left > 0:
                self._plane_left -= 1
        else:
            self._plane_stale = 0
        for c, cell in enumerate(self.cells):
            if self._elastic[c]:
                # intra-cell routing: reactive weighted-capacity over the
                # cell's OWN (locally fresh) node state
                cell.route(normalize_fractions(cell.capacity(),
                                               mask=cell.up_mask()))
                self._live_m[c] = cell.tick(0.0)
            else:
                fr = normalize_fractions(cell.capacity(),
                                         mask=cell.state.up)
                rate = float(arrival_rate) * float(w[c]) + fluid_extra[c]
                self._live_m[c] = cell.tick(rate, fr)
            # feed update: partitioned cells age instead (their live
            # metrics exist — the plane just can't see them)
            if plane_dark or self._partition[c] != 0:
                self.views[c].age()
                if self._partition[c] > 0:
                    self._partition[c] -= 1
            else:
                self.views[c].update(*self._snapshot(c))
        healthy = self.router.healthy(self.views, self._alive,
                                      self._plane_stale)
        self.quarantine_ticks += int(
            sum(1 for c in range(self.n_cells)
                if self._alive[c] and not healthy[c]))
        self._m = self._aggregate(arrival_rate)
        return self._m

    # ------------------------------------------------------------- metrics
    def _lease_util(self) -> np.ndarray:
        util = np.zeros(self.n_cells, np.float32)
        for c, cell in enumerate(self.cells):
            lease = getattr(cell, "lease", None)
            if lease is not None and lease[1] > 0:
                util[c] = self.cell_in_flight(c) / float(lease[1])
        return util

    def _take_local_actions(self) -> int:
        n, self._local_actions_acc = self._local_actions_acc, 0
        return n

    def _aggregate(self, arrival_rate: float) -> dict:
        """Federation metrics. Plane-facing ARRAYS come from the views
        (honest staleness); scalar accounting counters (served / goodput /
        timed_out / shed, dispatch counters) sum the cells' live metrics —
        a partition degrades control, not the experiment's bookkeeping."""
        views = self.views
        live = self._live_m
        up = self.up_mask()
        util = np.asarray([v.snap["util"] for v in views], np.float32)
        served = float(sum(m.get("served", 0.0) for m in live))
        goodput = float(sum(m.get("goodput", 0.0) for m in live))
        timed_out = float(sum(m.get("timed_out", 0.0) for m in live))
        culled = len(self.culled) - self._culled_reported
        self._culled_reported = len(self.culled)
        timed_out += float(sum(1 for r in self.culled[-culled:]
                               if r.expired)) if culled else 0.0
        shed = float(self.shed_total - self._shed_reported)
        self._shed_reported = self.shed_total
        # response time: served-weighted over views (what the plane may see)
        resp_w = np.asarray([max(v.metrics.get("served", 0.0), 0.0)
                             for v in views], np.float64)
        resp_v = np.asarray([v.metrics.get("response_time", 0.0)
                             for v in views], np.float64)
        resp = float((resp_w * resp_v).sum() / resp_w.sum()) \
            if resp_w.sum() > 0 else float(resp_v.mean())
        overload = float(np.mean([v.metrics.get("overload", 0.0)
                                  for v in views]))
        m = {
            "utilization": util,
            "mean_utilization": float(np.mean(util[up > 0.5])
                                      if (up > 0.5).any() else 0.0),
            "response_time": resp,
            "served": served,
            "overload": overload,
            "capacity": self.capacity(),
            "queue": self.queue_depths(),
            "up": up,
            "active_replicas": np.asarray(
                [v.snap["active"] for v in views], np.int32),
            "replica_ticks": int(sum(m.get("replica_ticks", 0)
                                     for m in live)),
            "decode_dispatches": int(sum(m.get("decode_dispatches", 0)
                                         for m in live)),
            "prefill_dispatches": int(sum(m.get("prefill_dispatches", 0)
                                          for m in live)),
            "syncs": int(sum(m.get("syncs", 0) for m in live)),
            "sync_wait_s": float(sum(m.get("sync_wait_s", 0.0)
                                     for m in live)),
            "fleet_groups": int(sum(m.get("fleet_groups", 0)
                                    for m in live)),
            "goodput": goodput,
            "timed_out": timed_out,
            "preempt_risk": self.preempt_risk(),
            # the multi-cell degraded-mode view (zeros in single-cell
            # backends — see control/backend.py protocol docs)
            "cell_staleness": self.cell_staleness(),
            "cell_risk": self.preempt_risk(),
            "shed": shed,
            "shed_total": int(self.shed_total),
            "router_weights": self._weights.copy(),
            "router_pending": len(self.pending),
            "quarantined": np.asarray(
                [float(max(self.views[c].staleness - self._plane_stale, 0)
                       > self.router.max_staleness)
                 for c in range(self.n_cells)], np.float32),
            # hierarchical-control view: plane-outage clock, lease
            # utilization (live in-flight over lease max, 0 when no lease)
            # and this tick's CellController scale actions — all zero in
            # centralized mode, so planner guards stay shape-stable
            "plane_staleness": float(self._plane_stale),
            "lease_util": self._lease_util(),
            "local_actions": float(self._take_local_actions()),
        }
        rates = [c.service_rate for e, c in zip(self._elastic, self.cells)
                 if e and c.service_rate]
        m["service_rate"] = float(np.mean(rates)) if rates else None
        if len(self.tiers) > 1:
            tq = np.zeros((len(self.tiers), self.n_cells), np.float32)
            for c, v in enumerate(views):
                cell_tq = v.metrics.get("tier_queue")
                if cell_tq is not None and len(cell_tq) == len(self.tiers):
                    tq[:, c] = np.asarray(cell_tq).sum(axis=1)
                else:
                    tq[self.tiers.priority[-1], c] = v.snap["queue"]
            costs = [m2.get("tier_slo_cost") for m2 in live
                     if m2.get("tier_slo_cost") is not None]
            tier_served: dict = {}
            for m2 in live:
                for k, n in (m2.get("tier_served") or {}).items():
                    tier_served[k] = tier_served.get(k, 0) + n
            m.update(tier_queue=tq, tier_pressure=self.tiers.pressure(tq),
                     tier_slo_cost=float(np.mean(costs)) if costs else 0.0,
                     tier_served=tier_served)
        return m

    # ------------------------------------------------------------ draining
    def run_until_drained(self, max_steps: int = 10_000):
        """Finish all outstanding work across the federation (chaos and
        partitions pause; blacked-out cells restore if parked work has
        nowhere else to go — the global twin of the frontend's drain-worker
        safety)."""
        chaos, self.chaos = self.chaos, None
        self._partition[:] = 0
        self._plane_left = 0          # a drain is a controlled wind-down:
        self._plane_stale = 0         # the plane outage ends with the run
        try:
            for _ in range(max_steps):
                if self._outstanding() == 0:
                    return
                eidx = self._elastic_cells()
                if self.pending and not any(self._alive[c] for c in eidx):
                    self.cell_up(eidx[0])     # parked work needs a home
                for c in eidx:
                    cell = self.cells[c]
                    if not self._alive[c] or cell._outstanding() == 0:
                        continue
                    if not any(n.live or n.spawning for n in cell.nodes):
                        host = next((n for n in cell.nodes if not n.down
                                     and n.preempt_left < 0), None)
                        if host is None:
                            host = cell.nodes[0]
                            host.down = False
                        cell._go_live(host)
                self.tick(0.0)
            raise RuntimeError("multi-cell federation did not drain")
        finally:
            self.chaos = chaos
