"""The port's fluid cluster simulator (``repro_torch.sim``) against the
reference's, in one process, and its invariants on its own.

The same numpy inputs go to both packages. ``_tick_math`` must agree within
1e-6 relative (XLA fuses the reference's jitted update, the port runs eager
torch ops; both are f32). A whole simulator run -- heterogeneous speeds,
failures, stragglers, scripted chaos, tiers, leases, scaling -- draws from
the same numpy generator in the same order on both sides, so its discrete
state (replicas, pending, up/down, notices) must be equal tick by tick and
its float metrics within 1e-5 relative (per-tier backlogs within 1e-5 of
the largest, see ``_assert_ticks_match``). The invariants mirror
``tests/test_sim.py`` (work conservation, utilization bounds, latency
growing with load, provisioning delay, immediate scale-down, rerouting of a
failed node's work, heterogeneous capacity) over a few seeds each.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cluster import ClusterConfig as JaxClusterConfig
from repro.configs import get_config as jax_get_config
from repro.serving import ChaosSchedule as JaxChaos
from repro.sim import cluster as jcluster
from repro.sim import service_rate as jrate
from repro.workload import parse_tiers as jax_parse_tiers
from repro.workload import trace as jtrace
from repro_torch.configs import get_config
from repro_torch.configs.paper_cluster import ClusterConfig
from repro_torch.control.backend import SimBackend
from repro_torch.serving.elastic import ChaosSchedule
from repro_torch.sim import cluster as tcluster
from repro_torch.sim import service_rate as trate
from repro_torch.workload import trace as ttrace
from repro_torch.workload.trace import parse_tiers

CFG = ClusterConfig(num_nodes=6, provisioning_delay=5)
SIM_KEYS = ("mean_utilization", "response_time", "served", "overload")


def _uniform(n):
    return np.full(n, 1.0 / n, np.float32)


def _sim(cfg, **kw):
    return tcluster.ClusterSim(cfg, 30.0, device="cpu", **kw)


# ------------------------------------------------------------- tick math
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tick_math_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = 7
    queue = rng.uniform(0, 50, n).astype(np.float32)
    cap = rng.uniform(0, 40, n).astype(np.float32)
    cap[rng.integers(0, n)] = 0.0                 # a node with no capacity
    frac = rng.dirichlet(np.ones(n)).astype(np.float32)
    arrivals = np.float32([0.0, 3.7, 250.0, 1e4][seed])
    dt, st = np.float32(1.0), np.float32(1 / 30.0)
    want = jcluster._tick_math(*(jnp.asarray(a) for a in
                                 (queue, cap, frac, arrivals, dt, st)))
    got = tcluster._tick_math(*(torch.from_numpy(np.array(a)) for a in
                                (queue, cap, frac, arrivals, dt, st)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)


# ------------------------------------------------------- whole simulator
def _state(sim):
    s = sim.state
    return (s.active.tolist(), s.pending.tolist(), s.up.tolist(),
            s.down_left.tolist(), s.slow_left.tolist(),
            s.notice_left.tolist(), sim._preempt_down.tolist())


def _assert_ticks_match(got, want):
    for k in SIM_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7)
    for k in ("utilization", "queue", "capacity"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)
    for k in ("up", "active_replicas", "replica_ticks"):
        np.testing.assert_array_equal(got[k], want[k])
    assert set(got) == set(want)
    if "tier_queue" in want:
        # a tier that one side drains to its last ulp keeps a residual of
        # that ulp's size on the other (served differs by f32 rounding):
        # tier backlogs are held to 1e-5 of the largest backlog
        scale = 1e-5 * max(1.0, float(np.abs(want["tier_queue"]).max()))
        np.testing.assert_allclose(got["tier_queue"], want["tier_queue"],
                                   rtol=1e-5, atol=scale)
        np.testing.assert_allclose(got["tier_pressure"],
                                   want["tier_pressure"], rtol=1e-5,
                                   atol=10 * scale)
        assert got["tier_response"].keys() == want["tier_response"].keys()
        for k, v in want["tier_response"].items():
            assert got["tier_response"][k] == pytest.approx(v, rel=1e-5)
        assert got["tier_slo_cost"] == pytest.approx(want["tier_slo_cost"],
                                                     rel=1e-5, abs=1e-7)


@pytest.mark.parametrize("case", ["failures", "chaos", "tiers"])
def test_sim_run_matches_reference(case):
    """A 60-tick run with fast failures and stragglers, scripted chaos or
    tiers, rates and fractions from numpy, scaling every 7 ticks and a
    lease: equal discrete state every tick, metrics within 1e-5."""
    kw = dict(num_nodes=5, provisioning_delay=3, node_mtbf=40.0,
              node_mttr=6.0, straggler_prob=0.2, straggler_mean_ticks=4.0)
    extra_j, extra_t = {}, {}
    if case == "chaos":
        spec = ("preempt@5:n1:k2,fail@9:n3,slow@12:n0:x3,recover@20:n1,"
                "slow@30:n0:x1,preempt@33:n4")
        extra_j = dict(chaos=JaxChaos.parse(spec), preempt_notice=1)
        extra_t = dict(chaos=ChaosSchedule.parse(spec), preempt_notice=1)
    elif case == "tiers":
        spec = "premium:0.3:w5:4,batch:0.7:w1"
        extra_j = dict(tiers=jax_parse_tiers(spec))
        extra_t = dict(tiers=parse_tiers(spec))
    jsim = jcluster.ClusterSim(JaxClusterConfig(**kw), 30.0, seed=4,
                               **extra_j)
    tsim = tcluster.ClusterSim(ClusterConfig(**kw), 30.0, seed=4,
                               device="cpu", **extra_t)
    np.testing.assert_array_equal(tsim.node_speed, jsim.node_speed)
    rng = np.random.default_rng(9)
    for t in range(60):
        rate = float(rng.uniform(20, 400))
        frac = rng.dirichlet(np.ones(5)).astype(np.float32)
        if t % 7 == 3:
            target = rng.integers(0, 8, 5).astype(np.int32)
            jsim.scale_to(target)
            tsim.scale_to(target)
        if t == 40:
            jsim.set_lease(4, 12)
            tsim.set_lease(4, 12)
        _assert_ticks_match(tsim.tick(rate, frac), jsim.tick(rate, frac))
        assert _state(tsim) == _state(jsim)
        np.testing.assert_allclose(
            tsim.observation(np.linspace(0.5, 1.5, 4, dtype=np.float32)),
            jsim.observation(np.linspace(0.5, 1.5, 4, dtype=np.float32)),
            rtol=1e-5, atol=1e-6)
    assert tsim.fetches == 60                   # one readback a tick


def test_blackout_and_restore_match_reference():
    kw = dict(num_nodes=3, provisioning_delay=2, node_mtbf=1e12,
              straggler_prob=0.0)
    jsim = jcluster.ClusterSim(JaxClusterConfig(**kw), 10.0, seed=1)
    tsim = tcluster.ClusterSim(ClusterConfig(**kw), 10.0, seed=1,
                               device="cpu")
    fr = _uniform(3)
    for sim in (jsim, tsim):
        for _ in range(4):
            sim.tick(80.0, fr)
    assert tsim.blackout() == pytest.approx(jsim.blackout(), rel=1e-6)
    assert _state(tsim) == _state(jsim)
    for sim in (jsim, tsim):
        sim.tick(10.0, fr)
        sim.restore()
    assert _state(tsim) == _state(jsim)
    for _ in range(4):
        _assert_ticks_match(tsim.tick(50.0, fr), jsim.tick(50.0, fr))
    assert _state(tsim) == _state(jsim)


def test_sim_backend_matches_reference():
    from repro.control.backend import SimBackend as JaxSimBackend
    kw = dict(num_nodes=4, provisioning_delay=2)
    jb = JaxSimBackend(jcluster.ClusterSim(JaxClusterConfig(**kw), 30.0,
                                           seed=2))
    tb = SimBackend(tcluster.ClusterSim(ClusterConfig(**kw), 30.0, seed=2,
                                        device="cpu"))
    assert tb.num_nodes == 4
    fc = np.linspace(1.0, 2.0, 32, dtype=np.float32)
    for t in range(5):
        fr = np.random.default_rng(t).dirichlet(np.ones(4)).astype(
            np.float32)
        jb.route(fr)
        tb.route(fr)
        _assert_ticks_match(tb.tick(120.0), jb.tick(120.0))
        assert tb.metrics() is tb._m
        for name in ("up_mask", "queue_depths", "capacity", "in_flight"):
            np.testing.assert_allclose(getattr(tb, name)(),
                                       getattr(jb, name)(), rtol=1e-6)
        np.testing.assert_allclose(tb.observe(fc), jb.observe(fc),
                                   rtol=1e-5, atol=1e-6)
        tb.scale_to(np.full(4, 3))
        jb.scale_to(np.full(4, 3))
    np.testing.assert_array_equal(tb.node_speed, jb.node_speed)


def test_sim_defaults_to_cuda(monkeypatch):
    """Like every entry point of the port, the simulator runs its tick on
    the card unless the caller names the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tcluster.ClusterSim(CFG, 30.0)


# --------------------------------------------- invariants (test_sim.py)
@pytest.mark.parametrize("seed,rate", [(0, 1.0), (7, 120.0), (31, 499.0)])
def test_work_conservation(seed, rate):
    """arrivals == served + queued (no failures -> no work lost)."""
    sim = _sim(CFG, seed=seed, failures=False)
    total_in, total_served = 0.0, 0.0
    for _ in range(50):
        m = sim.tick(rate, _uniform(6))
        total_in += rate * CFG.tick_seconds
        total_served += m["served"]
    assert total_served + sim.state.queue.sum() == pytest.approx(
        total_in, rel=1e-4)


@pytest.mark.parametrize("seed", [0, 13, 29])
def test_utilization_bounds(seed):
    sim = _sim(CFG, seed=seed, failures=True)
    rng = np.random.default_rng(seed)
    for _ in range(80):
        m = sim.tick(float(rng.uniform(0, 400)), _uniform(6))
        assert 0.0 <= m["mean_utilization"] <= 1.0 + 1e-6
        assert (m["utilization"] >= -1e-6).all()
        assert (m["utilization"] <= 1.0 + 1e-6).all()
        assert m["response_time"] >= 0.0


def test_latency_increases_with_load():
    lo = _sim(CFG, seed=1, failures=False)
    hi = _sim(CFG, seed=1, failures=False)
    r_lo = [lo.tick(100.0, _uniform(6))["response_time"] for _ in range(60)]
    r_hi = [hi.tick(3000.0, _uniform(6))["response_time"]
            for _ in range(60)]
    assert np.mean(r_hi) > np.mean(r_lo)


def test_provisioning_delay_honored():
    sim = _sim(CFG, seed=0, failures=False)
    before = sim.state.active.copy()
    sim.scale_to(before + 2)
    for t in range(CFG.provisioning_delay - 1):
        sim.tick(10.0, _uniform(6))
        assert (sim.state.active == before).all(), t
    sim.tick(10.0, _uniform(6))
    assert (sim.state.active == before + 2).all()


def test_scale_down_immediate():
    sim = _sim(CFG, seed=0, failures=False)
    before = sim.state.active.copy()
    sim.scale_to(np.maximum(before - 1, 0))
    assert (sim.state.active == np.maximum(before - 1, 0)).all()


def test_failed_node_work_rerouted():
    cfg = ClusterConfig(num_nodes=4, node_mtbf=1.0, node_mttr=1e9,
                        provisioning_delay=2)
    sim = _sim(cfg, seed=3, failures=True)
    sim.state.queue[:] = 25.0
    total_before = sim.state.queue.sum()
    m = sim.tick(0.0, _uniform(4))
    # every node fails (mtbf=1) -> queues drop to the retry pool
    assert (m["served"] + sim.state.queue.sum() + sim.state.retry_pool
            == pytest.approx(total_before, rel=1e-4))


def test_heterogeneous_capacity():
    sim = _sim(CFG, seed=0, failures=False, heterogeneous=True)
    assert len(set(np.round(sim.capacity(), 3))) > 1


# ------------------------------------------------- service rate, workload
@pytest.mark.parametrize("arch", ["granite-3-8b", "mamba2-1.3b",
                                  "zamba2-2.7b", "grok-1-314b"])
def test_service_rate_formula_matches_reference(arch):
    """With the reference's hardware constants the port's formula gives the
    reference's rates; its defaults describe one H100 as a replica."""
    ref_hw = dict(peak_flops=jrate.PEAK_FLOPS, hbm_bw=jrate.HBM_BW,
                  chips=jrate.CHIPS_PER_REPLICA)
    jc, tc = jax_get_config(arch), get_config(arch)
    for batch, ctx in ((64, 4096), (8, 512)):
        assert trate.replica_decode_rate(tc, batch, ctx, **ref_hw) == \
            pytest.approx(jrate.replica_decode_rate(jc, batch, ctx),
                          rel=1e-12)
        assert trate.replica_request_rate(tc, batch, ctx, **ref_hw) == \
            pytest.approx(jrate.replica_request_rate(jc, batch, ctx),
                          rel=1e-12)
    one = trate.replica_decode_rate(tc)
    assert one == pytest.approx(trate.replica_decode_rate(
        tc, peak_flops=989e12, hbm_bw=3.35e12, chips=1))


def test_forecast_dataset_and_load_levels_match_reference():
    assert ttrace.LOAD_LEVELS == jtrace.LOAD_LEVELS
    arr = ttrace.generate_trace(ttrace.TraceConfig(ticks=300), seed=3,
                                load_scale=1.8)["arrivals"]
    got = ttrace.make_forecast_dataset(arr, 64, 8)
    want = jtrace.make_forecast_dataset(arr, 64, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (300 - 72, 64, 1)
