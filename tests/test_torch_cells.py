"""The port's multi-cell routing plane (``control.cells``) and two-level
control hierarchy (``control.hierarchy``) against the reference, in one
process, on reduced granite-3-8b with the reference's weights bridged.

Mirrors the request-level cases of ``tests/test_cells.py`` and
``tests/test_hierarchy.py``: the router's and the planner's pure logic on
the same views; single-cell parity; a blackout under retrying clients
(one ledger across cells, nothing served twice); full-blackout parking;
overload shedding with its ledger terminal; chaos plumbing; stragglers and
capacity leases on an elastic cell; a supervisor restored mid-run and one
with no controllers; a shed retry racing a cell restore. Each case runs on
both packages with the same requests and its token streams, finish clocks,
ledger and counts must be equal. ``--cells 2 --hierarchy`` through
``run_control_loop`` is held to the reference's too. The fluid
``ClusterSim`` cases are in ``tests/test_torch_hierarchy_fluid.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import control as jc
from repro.configs import get_config as jax_get_config
from repro.configs.paper_cluster import ClusterConfig as JaxClusterConfig
from repro.models import make_model as jax_make_model
from repro.serving import ChaosSchedule as JaxChaos
from repro.serving import ElasticClusterFrontend as JaxElastic
from repro.serving import ReplicaEngine as JaxReplica
from repro.serving import Request as JaxRequest
from repro.sim.cluster import ClusterSim as JaxClusterSim
from repro.workload import ClientPool as JaxPool
from repro.workload import parse_tiers as jax_parse_tiers
from repro_torch import control as tc
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.configs.paper_cluster import ClusterConfig
from repro_torch.launch import serve
from repro_torch.models.model import make_model
from repro_torch.serving.elastic import ChaosSchedule, ElasticClusterFrontend
from repro_torch.serving.engine import ReplicaEngine, Request
from repro_torch.sim.cluster import ClusterSim
from repro_torch.workload.clients import ClientPool
from repro_torch.workload.trace import parse_tiers
from test_torch_control_loop import (assert_loops_match,
                                     cached_reference_loop, port_loop)
from test_torch_vlm import _one_torch_thread  # noqa: F401

MAX_SEQ = 64


@pytest.fixture(scope="module")
def models():
    jm = jax_make_model(jax_get_config("granite-3-8b").reduced(), tp=1)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    tm = make_model(get_config("granite-3-8b").reduced(), tp=1)
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


class _Side:
    """One package's classes and a cell factory over its model."""

    def __init__(self, side, models):
        jm, jp, tm, tp = models
        self.jax = side == "jax"
        self.c = jc if self.jax else tc
        self.Request = JaxRequest if self.jax else Request
        self.Chaos = JaxChaos if self.jax else ChaosSchedule
        self.Pool = JaxPool if self.jax else ClientPool
        self.tiers = jax_parse_tiers if self.jax else parse_tiers
        self.vocab = jm.cfg.vocab_size
        self._m = (jm, jp) if self.jax else (tm, tp)

    def cell(self, nodes=1, replicas=1, tiers=None, **kw):
        m, p = self._m
        if self.jax:
            def make(rid):
                return JaxReplica(m, p, max_batch=2, max_seq=MAX_SEQ,
                                  rid=rid, tiers=tiers)
            return JaxElastic(make, nodes, initial_replicas=replicas,
                              tiers=tiers, **kw)

        def make(rid):
            return ReplicaEngine(m, p, max_batch=2, max_seq=MAX_SEQ, rid=rid,
                                 tiers=tiers, device="cpu")
        return ElasticClusterFrontend(make, nodes, initial_replicas=replicas,
                                      tiers=tiers, **kw)

    def req(self, i, plen=4, n_new=4, tier=None):
        r = self.Request(i, [1 + (i + j) % 97 for j in range(plen)],
                         max_new_tokens=n_new)
        if tier is not None:
            r.tier = tier
        return r


def _both(models, fn):
    """``fn`` run on each package; the two results must be equal."""
    got, want = fn(_Side("torch", models)), fn(_Side("jax", models))
    assert got == want
    return got


def _stream(fe):
    return sorted((r.rid, tuple(r.output), r.first_token_time, r.finish_time)
                  for r in fe.finished)


def _view(c, queue=0.0, capacity=1.0, pressure=None, risk=0.0,
          staleness=0, in_flight=0):
    v = c.MetricsView({"queue": queue, "capacity": capacity,
                       "pressure": queue if pressure is None else pressure,
                       "risk": risk, "in_flight": in_flight, "active": 1,
                       "speed": 1.0, "util": 0.0}, {})
    v.staleness = staleness
    return v


# ---------------------------------------------------- router and planner
def _router_cases(c):
    out = []
    r = c.CellRouter(4, max_staleness=2, confidence_decay=0.5, risk_bias=0.8)
    views = [_view(c, capacity=4.0), _view(c, capacity=4.0, staleness=1),
             _view(c, capacity=4.0, staleness=3), _view(c, capacity=4.0)]
    alive = np.array([True, True, True, False])
    fr = np.array([0.4, 0.3, 0.2, 0.1])
    out.append(r.weights(fr, views, alive).tolist())
    views[1].staleness = 2
    out.append(r.weights(fr, views, alive).tolist())
    out.append(c.CellRouter(2, risk_bias=0.8).weights(
        np.array([0.5, 0.5]), [_view(c, capacity=4.0, risk=1.0),
                               _view(c, capacity=4.0)],
        np.ones(2, bool)).tolist())
    out.append(c.CellRouter(3).weights(np.full(3, 1 / 3),
                                       [_view(c) for _ in range(3)],
                                       np.zeros(3, bool)).tolist())
    out.append(c.CellRouter(2, adaptive=False).weights(
        np.array([0.9, 0.1]), [_view(c, risk=1.0, staleness=9), _view(c)],
        np.ones(2, bool)).tolist())
    r = c.CellRouter(2, max_staleness=2)
    stale = [_view(c, staleness=4), _view(c, staleness=4)]
    out.append(r.healthy(stale, np.ones(2, bool)).tolist())
    out.append(r.healthy(stale, np.ones(2, bool),
                         plane_staleness=4).tolist())
    out.append(r.weights(np.full(2, 0.5), [_view(c, capacity=4.0,
                                                 staleness=3),
                                           _view(c, capacity=4.0)],
                         np.ones(2, bool), plane_staleness=3).tolist())
    return out


def test_router_weights_match_reference():
    """Fresh, stale, quarantined, dead, risky, all-dead, static split and
    plane-excused views (test_cells.py's and test_hierarchy.py's router
    cases): the same weights and health masks, to the last bit."""
    got, want = _router_cases(tc), _router_cases(jc)
    assert got == want
    assert got[3] == [0.0, 0.0, 0.0] and got[4] == [0.5, 0.5]


def _shed_cases(c, parse):
    tiers = parse("premium:0.3:w5:4,standard:0.3:w2,batch:0.4:w1")
    r = c.CellRouter(2, tiers=tiers, shed_threshold=2.0)
    alive = np.ones(2, bool)
    out = []
    for p0, p1 in ((40.0, 1.0), (10.0, 9.0), (400.0, 400.0)):
        views = [_view(c, pressure=p0, capacity=4.0),
                 _view(c, pressure=p1, capacity=4.0)]
        out.append(sorted(r.shed_tiers(views, alive)))
    out.append(sorted(r.shed_tiers(views, np.zeros(2, bool))))
    out.append(sorted(c.CellRouter(2, tiers=tiers).shed_tiers(views,
                                                              alive)))
    return out


def test_shed_tiers_match_reference():
    got = _shed_cases(tc, parse_tiers)
    assert got == _shed_cases(jc, jax_parse_tiers)
    assert got[:3] == [[], ["batch"], ["batch", "standard"]]


def _planner_cases(c):
    p = c.GlobalPlanner(3, total_budget=6, max_per_cell=8, min_per_cell=1,
                        lease_slack=0.5)
    views = [_view(c, queue=30.0, in_flight=4), _view(c, in_flight=1),
             _view(c, queue=30.0, in_flight=4)]
    alive = np.array([True, True, False])
    flights = np.array([4, 1, 4])
    out = [[x.astuple() for x in p.plan(views, alive, flights)]]
    views[0].staleness = 4
    out.append([x.astuple() for x in p.plan(views, alive, flights)])
    out.append([x.astuple() for x in p.plan(
        [_view(c, queue=30.0, risk=1.0, in_flight=4), views[1], views[2]],
        alive, flights)])
    return out


def test_global_planner_matches_reference():
    got = _planner_cases(tc)
    assert got == _planner_cases(jc)
    assert got[0][2] == (0, 0, 0) and got[0][0][2] > got[0][1][2]
    assert got[1][0][2] < got[0][0][2] and got[2][0][2] < got[0][0][2]
    with pytest.raises(ValueError, match="cannot cover"):
        tc.GlobalPlanner(4, total_budget=2, max_per_cell=4)
    with pytest.raises(ValueError, match="bad lease"):
        tc.CellLease(3, 2, 4)


def test_fluid_cells_are_refused():
    """Fluid cells take the routed rate mass, never requests: a federation
    of fluid cells refuses a submission, as the reference's does."""
    for mc, req in (
            (tc.MultiCellBackend([ClusterSim(ClusterConfig(num_nodes=2),
                                             2.0, device="cpu")]),
             Request(0, [1, 2], max_new_tokens=2)),
            (jc.MultiCellBackend([JaxClusterSim(
                JaxClusterConfig(num_nodes=2), 2.0)]),
             JaxRequest(0, [1, 2], max_new_tokens=2))):
        with pytest.raises(RuntimeError, match="elastic"):
            mc.submit(req)


# ------------------------------------------------------ elastic federations
def test_single_cell_parity_streams_and_dispatches(models):
    """One cell through the plane: the direct frontend's streams, syncs and
    dispatches, tick by tick, on both packages."""
    def run(s):
        direct = s.cell(nodes=2, seed=3)
        routed = s.c.MultiCellBackend([s.cell(nodes=2, seed=3)])
        counts = []
        for t in range(4):
            for i in range(2):
                direct.submit(s.req(2 * t + i))
                routed.submit(s.req(2 * t + i))
            md, mr = direct.tick(0.0), routed.tick(0.0)
            counts.append(tuple(m[k] for m in (md, mr) for k in (
                "syncs", "decode_dispatches", "prefill_dispatches")))
        direct.run_until_drained()
        routed.run_until_drained()
        assert _stream(routed) == _stream(direct)
        assert routed.ledger.balanced() and direct.ledger.balanced()
        return _stream(routed), counts, routed.sync_count()

    _, counts, _ = _both(models, run)
    assert all(c[:3] == c[3:] for c in counts)


def test_blackout_evacuates_exactly_once(models):
    """A cell killed mid-flight under retrying clients: its work re-routes
    to the sibling, the one ledger balances, nothing is served twice, and
    the clients' and the ledger's accounts are the reference's."""
    def run(s):
        rng = np.random.default_rng(0)

        def request_factory(rid, tick):
            plen = int(rng.integers(2, 8))
            return s.Request(rid, rng.integers(1, s.vocab, plen).tolist(),
                             max_new_tokens=int(rng.integers(3, 8)))

        mc = s.c.MultiCellBackend(
            [s.cell(seed=1), s.cell(seed=2)],
            chaos=s.Chaos.parse("cell_down@4:c0,cell_up@10:c0"), seed=0)
        pool = s.Pool(mc, 8, request_factory=request_factory,
                      think_time=1.0, timeout=10.0, max_retries=2, seed=5)
        for _ in range(16):
            pool.tick()
            mc.tick(0.0)
        pool.quiesce()
        mc.run_until_drained()
        pool.finalize()
        assert mc.cells[0].ledger is mc.ledger is mc.cells[1].ledger
        assert mc.ledger.balanced()
        return (_stream(mc), mc.ledger.balance(), pool.summary(),
                mc.evacuated_total, mc.cell_downs)

    _, bal, summary, evacuated, downs = _both(models, run)
    assert downs == 1 and evacuated > 0 and bal["double_served"] == 0
    assert summary["ok"] > 0


def test_full_blackout_parks_arrivals_then_recovers(models):
    def run(s):
        mc = s.c.MultiCellBackend(
            [s.cell(seed=1)],
            chaos=s.Chaos.parse("cell_down@2:c0,cell_up@5:c0"))
        for i in range(3):
            mc.submit(s.req(i))
        mc.tick(0.0)
        for i in range(3, 5):
            mc.submit(s.req(i))          # arrive into the outage
        m2 = mc.tick(0.0)
        parked = (m2["up"].tolist(), m2["router_weights"].tolist(),
                  m2["router_pending"], mc.tick(0.0)["router_pending"])
        mc.run_until_drained()
        assert mc.ledger.balanced() and mc.ledger.double_served == 0
        return _stream(mc), parked

    stream, parked = _both(models, run)
    assert [r[0] for r in stream] == list(range(5))
    assert parked[0] == [0.0] and parked[1] == [0.0]
    assert parked[2] > 0 and parked[3] == parked[2]


def test_overload_sheds_lowest_tier_with_ledger_terminal(models):
    def run(s):
        tiers = s.tiers("premium:0.5:w5:6,batch:0.5:w1")
        router = s.c.CellRouter(2, tiers=tiers, shed_threshold=2.0)
        mc = s.c.MultiCellBackend(
            [s.cell(tiers=tiers, seed=1), s.cell(tiers=tiers, seed=2)],
            tiers=tiers, router=router, seed=0)
        for t in range(8):
            for i in range(10):          # ~5x the federation's capacity
                mc.submit(s.req(10 * t + i, n_new=6,
                                tier="premium" if i % 2 == 0 else "batch"))
            mc.tick(0.0)
        mc.run_until_drained()
        return _stream(mc), mc.ledger.balance(), mc.ledger.per_tier, \
            mc.shed_total

    _, bal, per, shed = _both(models, run)
    assert shed > 0 and per["batch"]["shed"] > 0
    assert per.get("premium", {}).get("shed", 0) == 0
    assert bal["live"] == 0 and bal["double_served"] == 0
    assert bal["submitted"] == sum(bal[k] for k in (
        "finished", "timed_out", "abandoned", "rejected", "shed"))


def test_cell_chaos_validation_and_filtering(models):
    s = _Side("torch", models)
    mc = s.c.MultiCellBackend([s.cell()])
    with pytest.raises(ValueError, match="out of range"):
        mc.cell_down(3)
    with pytest.raises(ValueError, match="not down"):
        mc.cell_up(0)
    mc.cell_down(0)
    with pytest.raises(ValueError, match="already down"):
        mc.cell_down(0)
    mc.cell_up(0)
    mc2 = s.c.MultiCellBackend(
        [s.cell(chaos=s.Chaos.parse("preempt@1:n0:k1"))],
        chaos=s.Chaos.parse("preempt@1:n0:k1"))
    mc2.submit(s.req(0))
    mc2.tick(0.0)
    assert mc2._alive.tolist() == [True]     # the router skips node events
    assert mc2.cells[0].preempt_risk().tolist() == [1.0]  # the cell applies
    mc2.run_until_drained()
    assert mc2.ledger.balanced()
    with pytest.raises(ValueError, match="not down"):
        mc2.plane_up()
    mc2.plane_down(None)
    assert not mc2.plane_alive
    with pytest.raises(ValueError, match="already down"):
        mc2.plane_down(3)
    mc2.plane_up()
    mc2.plane_down(0)                        # a k0 crash is a no-op
    assert mc2.plane_alive and mc2.plane_outages == 1


# -------------------------------------------------------------- hierarchy
def test_elastic_slow_node_and_lease_clamps(models):
    """Stragglers (by call and by chaos event) and capacity leases on an
    elastic cell: the reference's capacities and in-flight totals."""
    def run(s):
        out = []
        fe = s.cell()
        out.append(fe.capacity().tolist())
        fe.slow_node(0, 4)
        out.append((fe.capacity().tolist(), fe.node_speed.tolist()))
        fe.slow_node(0, 1)
        out.append(fe.capacity().tolist())
        fe = s.cell(chaos=s.Chaos.parse("slow@2:n0:x4,slow@4:n0:x1"))
        for _ in range(4):
            fe.tick(0.0)
            out.append(fe.capacity().tolist())
        fe = s.cell(nodes=2, max_replicas_per_node=4)
        for lease, target in (((0, 3), [4, 4]), ((5, 8), [0, 0]),
                              (None, [1, 0])):
            if lease is None:
                fe.clear_lease()
            else:
                fe.set_lease(*lease)
            fe.scale_to(target)
            out.append(int(fe.in_flight().sum()))
        with pytest.raises(ValueError, match="bad lease"):
            fe.set_lease(3, 1)
        return out

    out = _both(models, run)
    assert out[:3] == [[2.0], ([0.5], [0.25]), [2.0]]
    assert out[3:7] == [[2.0], [0.5], [0.5], [2.0]]
    assert out[7:] == [3, 5, 1]


def test_restore_token_digest_parity_elastic(models):
    """A supervisor checkpointed at tick 5 and restored into a fresh one
    continues the uninterrupted run's plans and token streams, on both
    packages, and the two packages agree."""
    def run(s):
        def build():
            mc = s.c.MultiCellBackend([s.cell(seed=1), s.cell(seed=2)],
                                      seed=0)
            ctls = [s.c.CellController(mc, i) for i in range(2)]
            return mc, s.c.PlaneSupervisor(
                mc, s.c.GlobalPlanner(2, total_budget=4, max_per_cell=4),
                ctls, plan_interval=3)

        def drive(mc, sup, lo, hi):
            for t in range(lo, hi):
                mc.submit(s.req(2 * t))
                mc.submit(s.req(2 * t + 1))
                sup.step(0.0)

        mc_a, sup_a = build()
        drive(mc_a, sup_a, 0, 10)
        mc_a.run_until_drained()
        mc_b, sup_b = build()
        drive(mc_b, sup_b, 0, 5)
        ckpt = sup_b.checkpoint()
        sup_b2 = s.c.PlaneSupervisor(
            mc_b, s.c.GlobalPlanner(2, total_budget=4, max_per_cell=4),
            [s.c.CellController(mc_b, i) for i in range(2)],
            plan_interval=3)
        sup_b2.restore(ckpt)
        drive(mc_b, sup_b2, 5, 10)
        mc_b.run_until_drained()
        assert _stream(mc_a) == _stream(mc_b)
        assert sup_a.plan_log == sup_b.plan_log + sup_b2.plan_log
        assert mc_a.ledger.balanced() and mc_b.ledger.balanced()
        return _stream(mc_a), sup_a.plan_log, sup_a.summary()

    _both(models, run)


def test_supervisor_without_controllers_is_stream_transparent(models):
    def run(s):
        direct = s.c.MultiCellBackend([s.cell(seed=3)])
        routed = s.c.MultiCellBackend([s.cell(seed=3)])
        sup = s.c.PlaneSupervisor(
            routed, s.c.GlobalPlanner(1, total_budget=4, max_per_cell=4),
            [], plan_interval=2)
        counts = []
        for t in range(5):
            direct.submit(s.req(t))
            routed.submit(s.req(t))
            md, mr = direct.tick(0.0), sup.step(0.0)
            counts.append((md["syncs"], mr["syncs"], md["decode_dispatches"],
                           mr["decode_dispatches"], mr["plane_staleness"],
                           mr["local_actions"]))
        direct.run_until_drained()
        routed.run_until_drained()
        assert _stream(direct) == _stream(routed)
        return _stream(routed), counts, len(sup.plan_log)

    _, counts, plans = _both(models, run)
    assert all(c[0] == c[1] and c[2] == c[3] and c[4] == c[5] == 0.0
               for c in counts)
    assert plans > 0


def test_shed_retry_racing_cell_up_admitted_exactly_once(models):
    def run(s):
        tiers = s.tiers("premium:0.5:w5:8,batch:0.5:w1")
        mc = s.c.MultiCellBackend(
            [s.cell(tiers=tiers, seed=1), s.cell(tiers=tiers, seed=2)],
            tiers=tiers,
            router=s.c.CellRouter(2, tiers=tiers, shed_threshold=1.0),
            chaos=s.Chaos.parse("cell_down@2:c0,cell_up@8:c0"), seed=0)
        for t in range(1, 4):
            for i in range(8):
                mc.submit(s.req(10 * t + i, n_new=4,
                                tier="premium" if i % 2 == 0 else "batch"))
            mc.tick(0.0)
        rid = [r for r, st in mc.ledger.state.items()
               if st == "shed" and mc.ledger.tier[r] == "batch"][0]
        mc.router.shed_threshold = None
        for _ in range(4, 8):
            mc.tick(0.0)
        assert mc.submit(s.req(rid, n_new=4, tier="batch"))   # the retry
        mc.tick(0.0)                 # t=8: cell_up fires this tick
        mc.run_until_drained()
        assert mc.ledger.state[rid] == "finished"
        assert sum(1 for r in mc.finished if r.rid == rid) == 1
        return _stream(mc), mc.ledger.balance(), mc.ledger.retries

    _, bal, retries = _both(models, run)
    assert retries >= 1 and bal["double_served"] == 0


# ------------------------------------------------------------ serve level
CELL_LOOP = ["--device", "cpu", "--policy", "ours", "--ticks", "15",
             "--cells", "2", "--hierarchy", "--plan-interval-global", "4",
             "--clients", "10", "--timeout", "8", "--retries", "1",
             "--cell-chaos", "cell_down@4:c0,cell_up@9:c0,plane_down@10:k3"]


def test_control_loop_cells_hierarchy_matches_reference(models):
    """``--cells 2 --hierarchy`` with a cell blackout and clients through
    ``run_control_loop``: streams, finish clocks, ledger, per-tick counts,
    the clients' report, the plan log and the hierarchy summary equal the
    reference's."""
    jm, jp, tm, tp = models
    args = serve.build_parser().parse_args(CELL_LOOP)
    ref = cached_reference_loop(jm, jp, args)
    out = port_loop(tm, tp, args, ref)
    assert_loops_match(out, ref)
    fe = out["fe"]
    assert fe.cell_downs == 1 and fe.plane_outages == 1
    assert out["sup"].summary()["restores"] == 1
    assert fe.ledger.balanced() and fe.ledger.double_served == 0


def test_control_loop_cells_sharded_matches_reference(models):
    """The federation above over 2 virtual shards (``--devices 2``): every
    cell's fleet groups split over the mesh, through the blackout and the
    plane outage; the reference's loop is matched tick by tick."""
    jm, jp, tm, tp = models
    args = serve.build_parser().parse_args(CELL_LOOP + ["--devices", "2"])
    ref = cached_reference_loop(jm, jp, args)
    out = port_loop(tm, tp, args, ref)
    assert_loops_match(out, ref)
    assert out["fe"].ledger.balanced()
