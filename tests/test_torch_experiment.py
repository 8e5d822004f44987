"""The paper's experiment in the port (``repro_torch.sim.experiment``)
against the reference's, on the CPU, and its integration checks on its own
(the mirror of ``tests/test_experiment.py``).

Each episode runs the reference's ``ControlPlane`` over its ``ClusterSim``
and the port's over the port's, tick by tick, on ``tests/test_experiment.py``'s
cluster and trace (6 nodes, 250 ticks at load 1.8, seed 1). The numpy
bookkeeping draws alike on both sides; GPSO draws the reference's random
numbers through ``JaxKey`` (``TorchKey.from_seed`` is replaced for the
test); the balancer's weights are bridged. Tolerances: per-tick
utilization, response time and fairness within 1e-5 relative; the active
replicas of every tick, the replica-ticks and every GPSO plan equal; after a
training episode every leaf of the four DDPG trees within 1e-4.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_cluster import ClusterConfig as JaxClusterConfig
from repro.control.backend import SimBackend as JaxSimBackend
from repro.control.plane import ControlPlane as JaxPlane
from repro.core import balancer as jbal
from repro.sim import experiment as jexp
from repro.sim.cluster import ClusterSim as JaxClusterSim
from repro.workload import TraceConfig as JaxTraceConfig
from repro.workload import generate_trace as jax_generate_trace
from repro_torch.bridge import rl_from_jax
from repro_torch.configs.paper_cluster import ClusterConfig
from repro_torch.core import balancer as tbal
from repro_torch.core import gpso as tgpso
from repro_torch.core import tree
from repro_torch.sim import experiment as texp
from repro_torch.workload import TraceConfig, generate_trace
from test_torch_control import JaxKey

CFG = ClusterConfig(num_nodes=6)
JCFG = JaxClusterConfig(num_nodes=6)
TRACE = generate_trace(TraceConfig(ticks=250), seed=0, load_scale=1.8)
FEAT = 4 + CFG.horizon


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's ops here are small: one intra-op thread each, so that
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_keys(monkeypatch):
    """GPSO in the port draws the reference's numbers: every key made from
    a seed is a ``JaxKey`` over ``jax.random.PRNGKey(seed)``."""
    monkeypatch.setattr(tgpso.TorchKey, "from_seed", staticmethod(
        lambda seed, device="cuda": JaxKey(jax.random.PRNGKey(seed))))


def _np(state):
    return jax.tree.map(np.asarray, dataclasses.asdict(state))


def _jax_plane(trace, method, rl=None, **kw):
    """The reference's ``run_episode`` plane (``repro.sim.experiment``)."""
    b, s = jexp.METHOD_SPECS[method]
    seed = kw.pop("seed", 0)
    arrivals = trace["arrivals"]
    sim = JaxClusterSim(JCFG, 30.0, seed=seed,
                        failures=kw.pop("failures", True))
    return JaxPlane(JCFG, JaxSimBackend(sim), balancer=b, scaler=s,
                    unit_capacity=30.0, rl=rl,
                    forecast_scale=float(arrivals.mean()), seed=seed,
                    init_arrival=float(arrivals[:10].mean()), **kw)


def _assert_episodes_match(tplane, jplane, arrivals):
    """Tick by tick: the metrics ``collect_episode`` aggregates, the
    replicas (active and in flight) and the balancer's fractions."""
    for t in range(len(arrivals)):
        tm, jm = tplane.step(float(arrivals[t])), jplane.step(
            float(arrivals[t]))
        for k in ("mean_utilization", "response_time", "served"):
            assert tm[k] == pytest.approx(jm[k], rel=1e-5, abs=1e-9), (t, k)
        assert texp.jain_fairness(tm["utilization"] + 1e-6) == \
            pytest.approx(jexp.jain_fairness(jm["utilization"] + 1e-6),
                          rel=1e-5), t
        np.testing.assert_array_equal(tm["active_replicas"],
                                      jm["active_replicas"])
        np.testing.assert_array_equal(tplane.backend.in_flight(),
                                      jplane.backend.in_flight())
        np.testing.assert_allclose(tplane.fractions, jplane.fractions,
                                   atol=1e-6)


@pytest.mark.parametrize("method", ["RRA", "LCA", "HPA", "RBAS"])
def test_baseline_episode_matches_reference(method):
    tplane = texp.make_plane(CFG, TRACE, method, unit_capacity=30.0, seed=1,
                             device="cpu")
    jplane = _jax_plane(TRACE, method, seed=1)
    _assert_episodes_match(tplane, jplane, TRACE["arrivals"])
    # run_episode / summary on both packages
    got = texp.run_episode(CFG, TRACE, method, unit_capacity=30.0, seed=1,
                           device="cpu")
    want = jexp.run_episode(JCFG, TRACE, method, unit_capacity=30.0, seed=1)
    assert got.replica_ticks == want.replica_ticks
    for k, v in want.summary(warmup=20).items():
        assert got.summary(warmup=20)[k] == pytest.approx(v, rel=1e-5), k


def test_ours_untrained_matches_reference(jax_keys):
    """OURS with the reference's untrained weights bridged and GPSO drawing
    the reference's numbers: the same plans (replicas every tick), metrics
    within 1e-5."""
    jrl = jbal.RLBalancer(JCFG, FEAT, seed=0)
    trl = tbal.RLBalancer(CFG, FEAT, seed=0, device="cpu",
                          state=rl_from_jax(_np(jrl.state), "cpu"))
    tplane = texp.make_plane(CFG, TRACE, "OURS", unit_capacity=30.0,
                             rl=trl, seed=1, device="cpu")
    jplane = _jax_plane(TRACE, "OURS", rl=jrl, seed=1)
    _assert_episodes_match(tplane, jplane, TRACE["arrivals"])
    assert tplane.fetches == len(TRACE["arrivals"]) + 24   # + a plan a 10


def test_train_rl_balancer_matches_reference(jax_keys):
    """A training episode (150 ticks at load 1.5, exploring, no failures,
    seed 2, a DDPG update every 2 ticks once the replay holds a batch)
    through both packages' ``train_rl_balancer``: every leaf of the final
    actor, critic and targets within 1e-4, the same number of updates."""
    tr = generate_trace(TraceConfig(ticks=150), seed=3, load_scale=1.5)
    jtr = jax_generate_trace(JaxTraceConfig(ticks=150), seed=3,
                             load_scale=1.5)
    np.testing.assert_array_equal(tr["arrivals"], jtr["arrivals"])
    jrl = jexp.train_rl_balancer(JCFG, [jtr], unit_capacity=30.0,
                                 episodes=1, seed=2)
    init = jbal.RLBalancer(JCFG, FEAT, seed=2)
    trl = tbal.RLBalancer(CFG, FEAT, seed=2, device="cpu",
                          state=rl_from_jax(_np(init.state), "cpu"))
    out = texp.train_rl_balancer(CFG, [tr], unit_capacity=30.0, episodes=1,
                                 seed=2, device="cpu", rl=trl)
    assert out is trl
    assert trl.buffer.size == jrl.buffer.size == 149
    assert trl.fetches == 11                    # t = 130, 132, ..., 150
    for f in ("actor", "critic", "actor_target", "critic_target"):
        want = jax.tree.leaves(jax.tree.map(np.asarray,
                                            getattr(jrl.state, f)))
        for g, w in zip(tree.leaves(getattr(trl.state, f)), want):
            np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=0)
    np.testing.assert_allclose(trl.buffer.act[:149], jrl.buffer.act[:149],
                               atol=1e-5)


# ----------------------------------------- mirror of test_experiment.py
@pytest.mark.parametrize("method", ["RRA", "LCA", "HPA", "RBAS"])
def test_episode_runs(method):
    r = texp.run_episode(CFG, TRACE, method, unit_capacity=30.0, seed=1,
                         device="cpu")
    s = r.summary(warmup=20)
    assert np.isfinite(list(s.values())).all()
    assert 0 <= s["mean_util"] <= 1
    assert s["cost"] > 0


def test_ours_untrained_runs_and_scales():
    rl = tbal.RLBalancer(CFG, FEAT, seed=0, device="cpu")
    r = texp.run_episode(CFG, TRACE, "OURS", unit_capacity=30.0, rl=rl,
                         seed=1, device="cpu")
    s = r.summary(warmup=20)
    assert np.isfinite(list(s.values())).all()
    static = texp.run_episode(CFG, TRACE, "RRA", unit_capacity=30.0, seed=1,
                              device="cpu")
    assert s["cost"] != static.summary(20)["cost"]


def test_autoscaled_beats_static_on_latency_under_load():
    """At 1.8x load the static cluster saturates; OURS (the port's own
    weights and keys) must cut response time by at least the paper's
    28%."""
    rl = tbal.RLBalancer(CFG, FEAT, seed=0, device="cpu")
    ours = texp.run_episode(CFG, TRACE, "OURS", unit_capacity=30.0, rl=rl,
                            seed=1, device="cpu").summary(20)
    rra = texp.run_episode(CFG, TRACE, "RRA", unit_capacity=30.0, seed=1,
                           device="cpu").summary(20)
    assert ours["mean_resp"] < 0.72 * rra["mean_resp"]
    assert ours["scaling_efficiency"] > 0


def test_rl_training_improves_or_holds_reward():
    """DDPG training on the sim is stable (no NaN), the critic learns, and
    the plane's state checkpoint still round-trips with a training
    balancer."""
    rl = tbal.RLBalancer(CFG, FEAT, seed=0, device="cpu")
    tr = generate_trace(TraceConfig(ticks=150), seed=3, load_scale=1.5)
    plane = texp.make_plane(CFG, tr, "OURS", unit_capacity=30.0, rl=rl,
                            train_rl=True, explore=True, failures=False,
                            seed=2, device="cpu")
    texp.collect_episode(plane, tr["arrivals"], "OURS", CFG, 30.0)
    m = rl.train_step()
    assert np.isfinite(m.get("critic_loss", 0.0))
    obs = np.random.default_rng(0).normal(
        size=(CFG.num_nodes, FEAT)).astype(np.float32)
    a = rl.act(torch.from_numpy(obs), torch.ones(CFG.num_nodes))
    assert float(torch.sum(a)) == pytest.approx(1.0, abs=1e-4)
    assert bool(torch.isfinite(a).all())
    assert plane.host_s["learn"] > 0.0
    fresh = texp.make_plane(CFG, tr, "OURS", unit_capacity=30.0, rl=rl,
                            train_rl=True, seed=2, device="cpu")
    fresh.load_state_dict(plane.state_dict())
    assert fresh.t == plane.t and fresh._prev is None
    fresh.step(float(tr["arrivals"][0]))


def test_methods_registered():
    for m in ("RRA", "LCA", "HPA", "RBAS", "OURS"):
        assert m in texp.METHOD_SPECS
    assert texp.METHODS == jexp.METHODS
