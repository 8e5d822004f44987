"""The port's fleet engine and elastic frontend against the JAX package, in
one process, on reduced granite-3-8b with the reference's weights bridged.

The same requests (numpy, seeded) and the same churn script go through the
reference's ``ElasticClusterFrontend`` (fleet-batched, async tick: its
default) and through the port's in three modes -- fleet + async, fleet +
eager (``async_tick=False``) and per-replica (``fleet_batch=False``).
Token streams and TTFT/finish clocks must be identical across all four;
the port's dispatch and sync counters must equal the reference's for the
same mode. Mirrors ``tests/test_fleet.py``, ``tests/test_async_serve.py``
and ``tests/test_control.py``. Digests are computed live, never pinned.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import make_model as jax_make_model
from repro.serving import ChaosSchedule as JaxChaos
from repro.serving import ClusterFrontend as JaxClusterFrontend
from repro.serving import ElasticClusterFrontend as JaxElastic
from repro.serving import ReplicaEngine as JaxReplica
from repro.serving import Request as JaxRequest
from repro.serving import RequestLedger as JaxLedger
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import make_model
from repro_torch.serving.elastic import (ChaosSchedule,
                                         ElasticClusterFrontend,
                                         RequestLedger)
from repro_torch.serving.engine import (ClusterFrontend, FleetGroup,
                                        ReplicaEngine, Request)
from test_torch_vlm import _one_torch_thread  # noqa: F401

MAX_SEQ = 64
SPEEDS = (0.7, 1.0, 1.4)


@pytest.fixture(scope="module")
def models():
    jm = jax_make_model(jax_get_config("granite-3-8b").reduced(), tp=1)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    tm = make_model(get_config("granite-3-8b").reduced(), tp=1)
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _reqs(cls, n, n_new=6, seed=3):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(1, 400, rng.integers(3, 9)).tolist(),
                max_new_tokens=n_new) for i in range(n)]


def _snap(reqs):
    return {r.rid: (tuple(r.output), r.first_token_time, r.finish_time)
            for r in reqs}


def _factory(side, models, hetero=False, max_batch=2):
    """Replica factory of one package; ``hetero`` cycles speeds (masked
    sub-step rounds) and alternates two max_batch values (two groups)."""
    jm, jp, tm, tp = models

    def make(rid):
        kw = dict(max_batch=max_batch, max_seq=MAX_SEQ, rid=rid)
        if hetero:
            kw.update(speed=SPEEDS[rid % 3],
                      max_batch=(2, 4)[(rid // 3) % 2])
        if side == "jax":
            return JaxReplica(jm, jp, **kw)
        return ReplicaEngine(tm, tp, device="cpu", **kw)
    return make


def _churn(side, models, hetero=False, **fe_kw):
    """tests/test_fleet.py's churn script: failure with work in flight,
    graceful drain, scale-up, then drain to empty."""
    cls = JaxElastic if side == "jax" else ElasticClusterFrontend
    fe = cls(_factory(side, models, hetero), 2, initial_replicas=2, seed=0,
             **fe_kw)
    reqs = _reqs(JaxRequest if side == "jax" else Request, 12)
    for r in reqs:
        fe.submit(r)
    per_tick = [fe.tick(0.0)]
    fe.fail_replica(0, 0)
    per_tick.append(fe.tick(0.0))
    fe.scale_to(np.array([1, 1]))
    per_tick.append(fe.tick(0.0))
    fe.scale_to(np.array([2, 2]))
    fe.run_until_drained()
    counts = (fe.decode_dispatches(), fe.prefill_dispatches(),
              fe.sync_count(), fe.replicas_spawned, fe.failed_replicas)
    ticks = [(m["decode_dispatches"], m["prefill_dispatches"], m["syncs"],
              m["active_replicas"].tolist()) for m in per_tick]
    return _snap(reqs), counts, ticks, fe


MODES = {"fleet-async": {}, "fleet-eager": dict(async_tick=False),
         "no-fleet-prefill": dict(fleet_prefill=False),
         "no-fleet": dict(fleet_batch=False)}
_REFERENCE_RUNS: dict = {}


def _reference(key, run):
    """``run()`` once a key: the reference's runs are shared by the
    unsharded and the sharded cases (the reference's sharded run equals
    its unsharded one, tests/test_fleet_shard.py)."""
    if key not in _REFERENCE_RUNS:
        _REFERENCE_RUNS[key] = run()
    return _REFERENCE_RUNS[key]


# (mode, hetero, shards): every mode unsharded, the fleet modes over 2 and
# 4 virtual CPU shards too
CHURN_CASES = [pytest.param(m, h, 1, id=f"{m}-{h}")
               for h in (False, True) for m in sorted(MODES)] + [
    pytest.param(m, h, n, id=f"{m}-{h}-{n}shards") for n in (2, 4)
    for h in (False, True)
    for m in ("fleet-async", "fleet-eager", "no-fleet-prefill")]


@pytest.mark.parametrize("mode,hetero,shards", CHURN_CASES)
def test_churn_matches_reference(models, mode, hetero, shards):
    """Failure / drain / scale-up: every mode of the port gives the
    reference's streams and clocks, and the reference's counters for the
    same mode, totals and per tick. ``hetero`` mixes speeds 0.7/1.0/1.4
    (sub-step rounds where part of a group steps) and two max_batch
    groups. ``shards`` > 1 splits every fleet group's slab rows over a
    mesh of virtual CPU shards (growth re-partitions rows, removal
    backfills across shards), held to the same reference run: the
    reference's sharded run equals its unsharded one
    (tests/test_fleet_shard.py)."""
    kw = MODES[mode]
    want, want_counts, want_ticks = _reference(
        ("churn", mode, hetero),
        lambda: _churn("jax", models, hetero, **kw)[:3])
    mesh = None if shards == 1 else make_mesh(
        (shards,), ("fleet",), devices=["cpu"] * shards)
    got, counts, ticks, fe = _churn("torch", models, hetero, mesh=mesh,
                                    **kw)
    assert got == want
    assert counts == want_counts
    assert ticks == want_ticks
    assert fe.ledger.balanced() and len(fe.finished) == 12
    if mode == "no-fleet":
        assert counts[0] == 0
    else:
        assert counts[0] > 0
    if shards > 1:                       # more than one shard decoded
        assert fe.shard_dispatches()[1] > fe.decode_steps()


def test_arrivals_and_scaling_async_matches_eager(models):
    """Continuous arrivals, cold-start provisioning and scale-down/up churn
    (tests/test_async_serve.py): async equals eager equals the reference,
    with the reference's per-tick dispatch and sync counts."""
    def run(side, async_tick):
        cls = JaxElastic if side == "jax" else ElasticClusterFrontend
        req = JaxRequest if side == "jax" else Request

        def rf(rid, tick):
            return req(rid, [1 + rid % 50, 2, 3, 4], max_new_tokens=4)

        fe = cls(_factory(side, models, hetero=True), 2, initial_replicas=1,
                 provisioning_delay=2, request_factory=rf, seed=0,
                 est_tokens=4, async_tick=async_tick)
        ticks = []
        for t in range(24):
            m = fe.tick(1.6)
            ticks.append((m["decode_dispatches"], m["prefill_dispatches"],
                          m["syncs"], m["active_replicas"].tolist()))
            if t == 5:
                fe.scale_to(np.array([2, 1]))
            if t == 12:
                fe.scale_to(np.array([3, 2]))
            if t == 18:
                fe.scale_to(np.array([1, 2]))
        fe.run_until_drained()
        return sorted((r.rid, tuple(r.output), r.first_token_time,
                       r.finish_time) for r in fe.finished), ticks

    want, want_ticks = run("jax", True)
    got, ticks = run("torch", True)
    assert got == want and ticks == want_ticks
    assert run("torch", False)[0] == want


def test_one_dispatch_and_one_sync_per_group_per_tick(models):
    """4 same-shape replicas on 2 nodes form ONE group: one decode
    dispatch per tick, and under the async tick exactly one sync per
    steady tick; the eager oracle pays more syncs for the same work."""
    def run(async_tick):
        fe = ElasticClusterFrontend(_factory("torch", models), 2,
                                    initial_replicas=2, seed=0,
                                    async_tick=async_tick)
        for r in _reqs(Request, 16, n_new=8):
            fe.submit(r)
        return fe, [fe.tick(0.0) for _ in range(4)]

    fe, ms = run(True)
    assert ms[0]["syncs"] <= 1
    for m in ms[1:]:
        assert m["fleet_groups"] == 1
        assert m["decode_dispatches"] == 1 and m["syncs"] == 1
    fe_e, ms_e = run(False)
    assert all(m["syncs"] >= 1 for m in ms_e)
    assert fe_e.sync_count() > fe.sync_count()


def test_masked_round_keeps_other_rows_bit_for_bit(models):
    """A round where only one member steps writes K/V into its own slab
    rows only: the other member's rows and operands do not change."""
    _, _, tm, tp = models
    engs = [ReplicaEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ, rid=i,
                          device="cpu") for i in range(3)]
    g = FleetGroup(tm, tp, max_batch=2, max_seq=MAX_SEQ, async_mode=True,
                   device="cpu")
    for e in engs:
        g.add(e)
    assert g.cap == 4 and g.peak_rows == 8
    for e, r in zip(engs, _reqs(Request, 6, n_new=9)):
        e.submit(r)
    for e in engs:
        e.begin_step(admit=False)
    g.admit_round()
    g.decode_round()
    g.reconcile()
    before = {n: s.clone() for n, s in g.slab.items()}
    ops_before = {n: o.clone() for n, o in g.ops.items()}
    engs[1].begin_step(admit=False)
    g.decode_round({id(engs[1])})
    rows = g._rows(1)
    for n, s in g.slab.items():
        keep = torch.ones(s.shape[1], dtype=torch.bool)
        keep[rows] = False
        assert torch.equal(s[:, keep], before[n][:, keep])
        assert not torch.equal(s[:, rows], before[n][:, rows])
    for n, o in g.ops.items():
        assert torch.equal(o[[0, 2, 3]], ops_before[n][[0, 2, 3]])
    assert g.reconcile() == [] and g.syncs == 2


def test_join_and_leave_mid_generation(models):
    """A standalone replica with in-flight slots joins a fleet (its cache
    rides into the slab), swap-backfill moves a member's rows on removal,
    and the replica leaves again (its rows unstack) without perturbing
    its greedy stream (tests/test_fleet.py)."""
    _, _, tm, tp = models
    mk = lambda: ReplicaEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ,
                               device="cpu")
    oracle, eng, other, third = mk(), mk(), mk(), mk()
    reqs_o, reqs_e = _reqs(Request, 2, n_new=9), _reqs(Request, 2, n_new=9)
    for a, b in zip(reqs_o, reqs_e):
        oracle.submit(a)
        eng.submit(b)
    for _ in range(3):
        oracle.step()
        eng.step()
    g = FleetGroup(tm, tp, max_batch=2, max_seq=MAX_SEQ, device="cpu")
    g.add(other)
    g.add(eng)
    g.add(third)
    assert eng.cache is None and g.cap == 4
    g.remove(other, restore=False)         # eng's rows backfill row 0
    assert eng._fleet_row == 0 or third._fleet_row == 0
    for _ in range(3):
        oracle.step()
        eng.begin_step()
        g.decode_round()
    g.remove(eng)
    assert eng.cache is not None and eng._fleet is None
    for _ in range(30):
        oracle.step()
        eng.step()
        if eng.load == 0 and oracle.load == 0:
            break
    assert _snap(reqs_e) == _snap(reqs_o)


def test_cluster_frontend_fleet_matches_reference(models):
    """The static frontend's fleet path (one decode dispatch per group per
    step, fleet admission) against the reference's."""
    want = _reference("cluster", lambda: _cluster_run("jax", models, True))
    assert _cluster_run("torch", models, True) == want and want[1] > 0
    assert _cluster_run("torch", models, False)[0] == want[0]


def _cluster_run(side, models, fleet, mesh=None):
    """Three replicas behind the static frontend: streams, clocks and the
    groups' decode dispatches."""
    mk = _factory(side, models)
    fe = (JaxClusterFrontend if side == "jax" else ClusterFrontend)(
        [mk(i) for i in range(3)], policy="lc", seed=0, fleet_batch=fleet,
        mesh=mesh)
    reqs = _reqs(JaxRequest if side == "jax" else Request, 9)
    for r in reqs:
        fe.submit(r)
    fe.run_until_drained()
    return _snap(reqs), sum(g.dispatches for g in fe.fleets.values())


def test_three_members_with_a_pad_row(models):
    """The three replicas above as one group over 4 virtual shards: cap 4,
    so one shard holds a pad row, masked out of every dispatch; the
    reference's streams, clocks and decode dispatch count."""
    want = _reference("cluster", lambda: _cluster_run("jax", models, True))
    mesh = make_mesh((4,), ("fleet",), devices=["cpu"] * 4)
    assert _cluster_run("torch", models, True, mesh) == want
    g = FleetGroup(models[2], models[3], max_batch=2, max_seq=MAX_SEQ,
                   mesh=mesh, device="cpu")
    mk = _factory("torch", models)
    for i in range(3):
        g.add(mk(i))
    assert g.cap == 4 and [p.rows for p in g.parts] == [1, 1, 1, 1]


def test_provisioning_drain_and_failure_semantics(models):
    """tests/test_control.py: cold start respects the provisioning delay;
    a drained replica finishes its in-flight work and admits nothing new;
    a failed replica's work re-queues with its progress reset."""
    mk = _factory("torch", models)
    fe = ElasticClusterFrontend(mk, 1, initial_replicas=1,
                                provisioning_delay=3)
    fe.scale_to(np.array([3]))
    assert fe.in_flight().tolist() == [3]
    live = []
    for _ in range(4):
        fe.tick(0.0)
        live.append(len(fe.nodes[0].live))
    assert live == [1, 1, 3, 3]

    fe = ElasticClusterFrontend(mk, 1, initial_replicas=2)
    reqs = _reqs(Request, 4, n_new=6)
    for r in reqs:
        fe.submit(r)
    fe.tick(0.0)
    fe.scale_to(np.array([1]))
    node = fe.nodes[0]
    drained = node.draining[0]
    assert drained.draining and drained.n_active > 0
    fe.run_until_drained()
    assert all(r.done and len(r.output) == 6 for r in reqs)
    assert node.draining == [] and len(node.live) == 1

    fe = ElasticClusterFrontend(mk, 1, initial_replicas=2)
    reqs = _reqs(Request, 4, n_new=5)
    for r in reqs:
        fe.submit(r)
    fe.tick(0.0)
    victim = fe.nodes[0].live[0]
    carried = [r for r in victim.slots if r is not None] + list(victim.queue)
    assert carried
    fe.fail_replica(0, 0)
    assert all(not r.done and r.output == [] for r in carried)
    fe.run_until_drained()
    assert all(r.done and len(r.output) == 5 for r in reqs)
    assert fe.ledger.balanced()


def test_chaos_preemption_matches_reference(models):
    """Scripted chaos (preempt with notice, recover, slow) with deadlines
    on the requests: the same streams and ledger terminals as the
    reference."""
    def run(side):
        cls = JaxElastic if side == "jax" else ElasticClusterFrontend
        chaos = (JaxChaos if side == "jax" else ChaosSchedule).parse(
            "preempt@2:n0:k1,slow@3:n1:x2,recover@6:n0,slow@8:n1:x1")
        fe = cls(_factory(side, models), 2, initial_replicas=2, seed=0,
                 chaos=chaos)
        reqs = _reqs(JaxRequest if side == "jax" else Request, 10, n_new=5)
        for i, r in enumerate(reqs):
            r.deadline_tick = 6.0 + i
            fe.submit(r)
        for _ in range(10):
            fe.tick(0.0)
            fe.scale_to(np.array([2, 2]))
        fe.run_until_drained()
        return _snap(reqs), fe.ledger.balance(), fe.preempted_replicas

    want = run("jax")
    got = run("torch")
    assert got == want
    assert got[1]["double_served"] == 0 and got[2] > 0


# ------------------------------------------------------- ledger and chaos
def test_request_ledger_matches_reference():
    script = [("register", 0), ("register", 0), ("resolve", 0, False),
              ("register", 1), ("reject", 1), ("register", 1),
              ("abandon", 1), ("resolve", 1, False), ("register", 2),
              ("resolve", 2, True), ("register", 2), ("register", 3),
              ("shed", 3), ("register", 3), ("resolve", 3, False),
              ("resolve", 3, False), ("abandon", 9)]

    def run(led, req_cls):
        out = []
        for op, rid, *arg in script:
            r = req_cls(rid, [1, 2], max_new_tokens=3)
            if op == "resolve":
                r.finish_time = 1.0
                r.output = [5] if arg[0] else [5, 5, 5]
                r.deadline_tick = 0.0 if arg[0] else None
                out.append(led.resolve(r))
            elif op == "abandon":
                out.append(led.abandon(rid))
            else:
                out.append(getattr(led, op)(r))
        return out, led.balance(), led.per_tier, led.balanced()

    assert run(RequestLedger(), Request) == run(JaxLedger(), JaxRequest)


@pytest.mark.parametrize("spec", [
    "preempt@12:n0:k3,fail@8:n1:r0,recover@40:n0,slow@5:n0:x4",
    "cell_down@15:c0,partition@10:c1:k6,heal@14:c1,cell_up@30:c0",
    "plane_down@12:k8,plane_up@20,slow@18:n1:x1"])
def test_chaos_schedule_parse_matches_reference(spec):
    got, want = ChaosSchedule.parse(spec), JaxChaos.parse(spec)
    assert got.events == want.events
    assert got.pop(12) == want.pop(12)


@pytest.mark.parametrize("bad", ["preempt@1:c0", "slow@3:n0",
                                 "fail@2:n0:k3", "plane_up@4:k2", "nope@1"])
def test_chaos_schedule_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        JaxChaos.parse(bad)
    with pytest.raises(ValueError):
        ChaosSchedule.parse(bad)


def test_unported_fleet_options_raise(models):
    """``mesh=`` is ported: the elastic frontend's groups split their slab
    over a fleet mesh (parity: the sharded cases of
    test_churn_matches_reference), and, as
    in the reference, a mesh without a 'fleet' axis is refused."""
    _, _, tm, tp = models
    mk = _factory("torch", models)
    fe = ElasticClusterFrontend(
        mk, 1, mesh=make_mesh((2,), ("fleet",), devices=["cpu", "cpu"]))
    assert [g.shards for g in fe._fleets.values()] == [2]
    with pytest.raises(ValueError, match="'fleet' axis"):
        FleetGroup(tm, tp, max_batch=2, max_seq=MAX_SEQ, device="cpu",
                   mesh=make_mesh((2,), ("data",), devices=["cpu", "cpu"]))
