"""The port's control-plane pieces against the JAX package, in one process.

Inputs come from numpy with a seed and go to both packages; the reference's
parameters (the DDPG actor and critic, the GRU forecaster) carry across
through ``repro_torch.bridge``. GPSO's random draws come from ``JaxKey``, a
key over ``jax.random`` keys split at the reference's places, so the port's
plans must equal the reference's. Tolerances: the GCN layer 1e-5 (the
reference's own, ``tests/test_kernels.py``); the Eq.9 fitness functions and
the plans exactly.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cluster import ClusterConfig as JaxClusterConfig
from repro.control.plane import ControlPlane as JaxPlane
from repro.core import autoscaler as jas
from repro.core import balancer as jbal
from repro.core import ddpg as jddpg
from repro.core import forecaster as jfc
from repro.core import gcn as jgcn
from repro.core import gpso as jgpso
from repro.kernels.gcn_fused import gcn_layer as jax_gcn_layer
from repro_torch.bridge import forecaster_from_jax, rl_from_jax
from repro_torch.configs.paper_cluster import ClusterConfig
from repro_torch.control.plane import ControlPlane
from repro_torch.core import autoscaler as tas
from repro_torch.core import balancer as tbal
from repro_torch.core import ddpg as tddpg
from repro_torch.core import forecaster as tfc
from repro_torch.core import gcn as tgcn
from repro_torch.core import gpso as tgpso
from repro_torch.kernels import ops, ref
from test_torch_vlm import _one_torch_thread  # noqa: F401

# the serve path's cluster (repro.launch.serve.run_control_loop)
CLUSTER = dict(num_nodes=2, horizon=8, forecast_window=16,
               provisioning_delay=3, max_replicas_per_node=4,
               min_replicas_per_node=1, scale_interval=5, cooldown=8,
               straggler_prob=0.0, node_mtbf=1e12)
FEAT = 4 + CLUSTER["horizon"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


class JaxKey:
    """The GPSO key protocol (``repro_torch.core.gpso``) over ``jax.random``
    keys: the port's GPSO splits and draws at the reference's places, so
    with this key it sees the reference's random numbers."""

    def __init__(self, key):
        self.key = key

    def split(self, n=2):
        return [JaxKey(k) for k in jax.random.split(self.key, n)]

    def uniform(self, shape, lo=0.0, hi=1.0):
        return _t(jax.random.uniform(self.key, tuple(shape), minval=lo,
                                     maxval=hi))

    def randint(self, shape, lo, hi):
        return _t(jax.random.randint(self.key, tuple(shape), lo, hi))

    def categorical(self, logits, n):
        return _t(jax.random.categorical(
            self.key, jnp.asarray(logits.numpy()), shape=(n,)))


def _cfgs(**kw):
    return (JaxClusterConfig(**{**CLUSTER, **kw}),
            ClusterConfig(**{**CLUSTER, **kw}))


def _np(tree):
    if dataclasses.is_dataclass(tree):          # the reference's DDPGState
        tree = dataclasses.asdict(tree)
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------------- kernel
@pytest.mark.parametrize("N,F,H", [(8, 12, 16), (16, 36, 64), (32, 8, 8),
                                   (2, 12, 64), (2, 64, 64)])
@pytest.mark.parametrize("relu", [True, False])
def test_gcn_layer_ref_matches_pallas(N, F, H, relu):
    rng = np.random.default_rng(N * F + H)
    A = rng.uniform(size=(N, N)).astype(np.float32)
    X = rng.standard_normal((N, F), np.float32)
    W = rng.standard_normal((F, H), np.float32)
    b = rng.standard_normal(H).astype(np.float32)
    want = jax_gcn_layer(jnp.asarray(A), jnp.asarray(X), jnp.asarray(W),
                         jnp.asarray(b), relu=relu, interpret=True)
    got = ref.gcn_layer_ref(_t(A), _t(X), _t(W), _t(b), relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_ops_gcn_layer_takes_plain_path_on_cpu():
    rng = np.random.default_rng(0)
    A, W = (_t(rng.uniform(size=s).astype(np.float32))
            for s in ((5, 5), (7, 3)))
    b = _t(rng.standard_normal(3).astype(np.float32))
    X = _t(rng.standard_normal((4, 5, 7), np.float32))
    ops.reset_launches()
    got = ops.gcn_layer(A, X, W, b, relu=False)
    assert ops.LAUNCHES["gcn_layer"] == 0       # no kernel on the CPU
    assert got.shape == (4, 5, 3)
    torch.testing.assert_close(got, ref.gcn_layer_ref(A, X, W, b, relu=False),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.gcn_layer(A, X[1], W, b), torch.relu(
        A @ X[1] @ W + b), rtol=1e-6, atol=1e-6)


# -------------------------------------------------------------- GCN + DDPG
@pytest.mark.parametrize("act", ["relu-default", "tanh", "tanh-grad"])
def test_gcn_apply_activation_matches_reference(act):
    """``gcn_apply(..., activation=)`` as the reference's: three layers
    over 5 nodes with drawn biases, the inner activation relu (the default,
    fused in the kernel) or tanh (after a kernel without relu), a sigmoid
    on the last layer; 1e-6. Under "tanh-grad" the weights need a gradient,
    so the layers run as ``GCNLayer``, and d<out, g>/dW of every layer
    equals ``jax.grad`` of the reference's."""
    rng = np.random.default_rng(4)
    jp = jgcn.init_gcn(jax.random.PRNGKey(4), 6, 8, 3, out_dim=3)
    jp = {"w": [np.asarray(w) for w in jp["w"]],
          "b": [(0.1 * rng.standard_normal(b.shape)).astype(np.float32)
                for b in jp["b"]]}
    a_hat = jgcn.normalize_adjacency(jgcn.make_topology(5))
    x = rng.standard_normal((2, 5, 6)).astype(np.float32)
    g = rng.standard_normal((2, 5, 3)).astype(np.float32)
    jkw = {} if act == "relu-default" else {"activation": jnp.tanh}
    tkw = {} if act == "relu-default" else {"activation": torch.tanh}
    tp = {k: [_t(a).requires_grad_(act == "tanh-grad") for a in v]
          for k, v in jp.items()}

    def jout(p):
        return jgcn.gcn_apply(p, jnp.asarray(a_hat), jnp.asarray(x),
                              final_activation=jax.nn.sigmoid, **jkw)
    out = tgcn.gcn_apply(tp, _t(a_hat), _t(x),
                         final_activation=torch.sigmoid, **tkw)
    close = dict(atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout(jp)),
                               **close)
    if act == "tanh-grad":
        (out * _t(g)).sum().backward()
        jg = jax.grad(lambda p: jnp.sum(jout(p) * g))(jp)
        for tw, jw in zip(tp["w"], jg["w"]):
            np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jw),
                                       **close)


@pytest.mark.parametrize("n,lead", [(2, ()), (5, (3,)), (16, (2, 2))])
def test_actor_and_critic_match_reference(n, lead):
    jcfg, _ = _cfgs(num_nodes=n)
    state = jddpg.init_ddpg(jax.random.PRNGKey(n), FEAT, jcfg)
    tstate = rl_from_jax(_np(state), device="cpu")
    rng = np.random.default_rng(n)
    a_hat = jgcn.normalize_adjacency(jgcn.make_topology(n, jcfg.topology))
    obs = rng.standard_normal(lead + (n, FEAT)).astype(np.float32)
    up = np.ones(lead + (n,), np.float32)
    up[..., -1] = 0.0
    act = rng.dirichlet(np.ones(n), lead).astype(np.float32) if lead \
        else rng.dirichlet(np.ones(n)).astype(np.float32)
    ja, jo = jnp.asarray(a_hat), jnp.asarray(obs)
    ta, to = _t(a_hat), _t(obs)
    close = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        tgcn.gcn_apply(tstate.actor["gcn"], ta, to).numpy(),
        np.asarray(jgcn.gcn_apply(state.actor["gcn"], ja, jo)), **close)
    want = np.asarray(jddpg.actor_action(state.actor, ja, jo,
                                         up_mask=jnp.asarray(up)))
    got = tddpg.actor_action(tstate.actor, ta, to, up_mask=_t(up)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert np.all(got[..., -1] == 0.0)           # down node gets nothing
    np.testing.assert_allclose(
        tddpg.critic_q(tstate.critic, ta, to, _t(act)).numpy(),
        np.asarray(jddpg.critic_q(state.critic, ja, jo, jnp.asarray(act))),
        **close)


def test_rl_balancer_act_matches_reference():
    jcfg, tcfg = _cfgs()
    jrl = jbal.RLBalancer(jcfg, FEAT, seed=3)
    trl = tbal.RLBalancer(tcfg, FEAT, seed=3, device="cpu",
                          state=rl_from_jax(_np(jrl.state), "cpu"))
    obs = np.random.default_rng(3).standard_normal((2, FEAT)) \
        .astype(np.float32)
    up = np.ones(2, np.float32)
    np.testing.assert_allclose(
        trl.act(_t(obs), _t(up)).numpy(),
        np.asarray(jrl.act(jnp.asarray(obs), jnp.asarray(up))), atol=1e-6)
    # an empty replay trains nothing on either side (the update itself is
    # held to the reference in tests/test_torch_train.py)
    assert trl.train_step() == {} == jrl.train_step()


def test_rl_balancer_initializes_from_a_torch_generator():
    _, tcfg = _cfgs()
    a = tbal.RLBalancer(tcfg, FEAT, seed=1, device="cpu")
    b = tbal.RLBalancer(tcfg, FEAT, seed=1, device="cpu")
    c = tbal.RLBalancer(tcfg, FEAT, seed=2, device="cpu")
    wa, wb, wc = (r.state.actor["gcn"]["w"][0] for r in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert wa.shape == (FEAT, tcfg.gcn_hidden)
    # targets start as copies, not aliases
    assert a.state.actor_target["gcn"]["w"][0] is not wa
    assert torch.equal(a.state.actor_target["gcn"]["w"][0], wa)


# ---------------------------------------------------------------- balancers
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_baseline_balancers_match_reference(seed):
    rng = np.random.default_rng(seed)
    n = 6
    queue = rng.integers(0, 20, n).astype(np.float32)
    cap = rng.uniform(1, 5, n).astype(np.float32)
    obs = rng.standard_normal((n, FEAT)).astype(np.float32)
    for up in (np.ones(n, np.float32), (rng.random(n) > 0.4)
               .astype(np.float32), np.zeros(n, np.float32)):
        j = [jnp.asarray(a) for a in (obs, up, queue, cap)]
        t = [_t(a) for a in (obs, up, queue, cap)]
        np.testing.assert_allclose(tbal.round_robin(t[0], t[1]).numpy(),
                                   np.asarray(jbal.round_robin(j[0], j[1])),
                                   atol=1e-7)
        np.testing.assert_allclose(
            tbal.weighted_capacity(t[0], t[1], t[3]).numpy(),
            np.asarray(jbal.weighted_capacity(j[0], j[1], j[3])), atol=1e-7)
        for total in (0.0, 3.5, 40.0):
            np.testing.assert_allclose(
                tbal.least_connections(t[2], t[1],
                                       torch.tensor(total)).numpy(),
                np.asarray(jbal.least_connections(j[2], j[1],
                                                  jnp.float32(total))),
                atol=1e-6)


def test_reward_fn_matches_reference():
    for args in ((3.0, 0.4, 1.0, 0.25, 0.1, 0.0), (0.0, 1.0, 0.5, 0.5, 0.0,
                                                   0.3)):
        assert tbal.reward_fn(*args) == jbal.reward_fn(*args)


# ---------------------------------------------------------------- Eq.9 GPSO
def _fitness_inputs(seed, n=2, P=64):
    rng = np.random.default_rng(seed)
    R = rng.uniform(0.0, 4.0, (P, n)).astype(np.float32)
    host = [rng.uniform(0.5, 6.0, n).astype(np.float32),
            rng.uniform(0.3, 1.5, n).astype(np.float32),
            np.float32(1.0), np.float32(32.0), np.float32(0.7),
            np.float32(8.0), rng.dirichlet(np.ones(n)).astype(np.float32),
            np.float32(4.0), (rng.random(n) > 0.5).astype(np.float32)]
    return R, host


@pytest.mark.parametrize("name,n_ctx", [
    ("eq9_fitness", 5), ("eq9_tiered_fitness", 7), ("eq9_risk_fitness", 7),
    ("eq9_tiered_risk_fitness", 9)])
@pytest.mark.parametrize("seed", [0, 1])
def test_eq9_fitness_matches_reference_exactly(name, n_ctx, seed):
    R, host = _fitness_inputs(seed)
    if name == "eq9_risk_fitness":
        host = host[:5] + host[7:]
    host = host[:n_ctx]
    want = getattr(jas, name)(jnp.asarray(R),
                              tuple(jnp.asarray(a) for a in host))
    got = getattr(tas, name)(_t(R), tuple(_t(a) for a in host))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ga_and_pso_steps_match_reference(seed):
    jcfg, tcfg = _cfgs()
    R, host = _fitness_inputs(seed)
    jctx = tuple(jnp.asarray(a) for a in host[:5])
    tctx = tuple(_t(a) for a in host[:5])
    key = jax.random.PRNGKey(seed)
    jcost = jas.eq9_fitness(jnp.asarray(R), jctx)
    kw = dict(crossover_p=jcfg.ga_crossover, mutation_p=jcfg.ga_mutation,
              elite=jcfg.ga_elite, lo=1.0, hi=4.0)
    jpop, jc = jgpso.ga_generation(key, jnp.asarray(R), jcost, jctx,
                                   fitness_fn=jas.eq9_fitness, **kw)
    tpop, tc = tgpso.ga_generation(JaxKey(key), _t(R), _t(jcost), tctx,
                                   fitness_fn=tas.eq9_fitness, **kw)
    np.testing.assert_array_equal(tpop.numpy(), np.asarray(jpop))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))

    vel = np.random.default_rng(seed).standard_normal(R.shape) \
        .astype(np.float32)
    pkw = dict(w=jcfg.pso_inertia, c1=jcfg.pso_c1, c2=jcfg.pso_c2, lo=1.0,
               hi=4.0)
    order = np.argsort(np.asarray(jc), kind="stable")
    args = [np.asarray(jpop), vel, np.asarray(jpop)[order],
            np.asarray(jc)[order], np.asarray(jpop)[order[0]],
            np.asarray(jc)[order[0]]]
    want = jgpso.pso_iteration(key, *map(jnp.asarray, args), jctx,
                               fitness_fn=jas.eq9_fitness, **pkw)
    got = tgpso.pso_iteration(JaxKey(key), *map(_t, args), tctx,
                              fitness_fn=tas.eq9_fitness, **pkw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_gpso_minimize_matches_reference(seed):
    jcfg, tcfg = _cfgs()
    _, host = _fitness_inputs(seed)
    key = jax.random.PRNGKey(seed)
    for minimize, name in ((jgpso.gpso_minimize, "gpso_minimize"),
                           (jgpso.ga_only_minimize, "ga_only_minimize")):
        jbest, jcost, jhist = minimize(
            key, jas.eq9_fitness, 2, jcfg, lo=1.0, hi=4.0,
            ctx=tuple(jnp.asarray(a) for a in host[:5]))
        tbest, tcost, thist = getattr(tgpso, name)(
            JaxKey(key), tas.eq9_fitness, 2, tcfg, lo=1.0, hi=4.0,
            ctx=tuple(_t(a) for a in host[:5]))
        np.testing.assert_array_equal(tbest.numpy(), np.asarray(jbest))
        # under jit XLA fuses the fitness and may round its last ulp
        # differently from the eager ops (eager, the two are bit-equal:
        # test_eq9_fitness_matches_reference_exactly); the plan is the same
        np.testing.assert_allclose(thist.numpy(), np.asarray(jhist),
                                   rtol=1e-6)


def test_torch_key_is_a_pure_value():
    k = tgpso.TorchKey.from_seed(7, device="cpu")
    a, b = k.split(2)
    assert torch.equal(a.uniform((4,)), a.uniform((4,)))
    assert not torch.equal(a.uniform((4,)), b.uniform((4,)))
    assert torch.equal(k.split(2)[0].uniform((3,)), a.uniform((3,)))
    u = copy.deepcopy(b).uniform((5,), 1.0, 4.0)
    assert torch.equal(u, b.uniform((5,), 1.0, 4.0))
    assert float(u.min()) >= 1.0 and float(u.max()) < 4.0
    draws = a.categorical(torch.tensor([0.0, 5.0, -5.0]), 200)
    assert draws.shape == (200,) and (draws == 1).float().mean() > 0.9
    r = b.randint((100, 1), 1, 3)
    assert set(r.flatten().tolist()) <= {1, 2}


def test_torch_key_defaults_to_cuda(monkeypatch):
    """Like every entry point of the port, the key runs on the card unless
    the caller names the CPU: with no CUDA it raises, never moves."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tgpso.TorchKey.from_seed(7)
    assert tgpso.TorchKey.from_seed(7, device="cpu").device.type == "cpu"


def test_gpso_autoscaler_plans_match_reference_over_ticks():
    """A sequence of plans, with scale-downs inside and outside the
    cooldown, tier pressure and preemption risk: equal targets."""
    jcfg, tcfg = _cfgs()
    jsc = jas.GPSOAutoscaler(jcfg, 1.0, seed=4)
    tsc = tas.GPSOAutoscaler(tcfg, 1.0, seed=4, device="cpu",
                             key=JaxKey(jax.random.PRNGKey(4)))
    rng = np.random.default_rng(4)
    current = np.array([3, 3], np.int32)
    fetched = []
    for tick in range(0, 60, 5):
        demand = rng.uniform(0.2, 6.0, 2).astype(np.float32)
        speed = rng.choice([0.7, 1.0, 1.4], 2).astype(np.float32)
        kw = dict(node_speed=speed)
        if tick % 15 == 5:
            kw["slo_pressure"] = rng.uniform(0, 3, 2).astype(np.float32)
        if tick % 20 == 10:
            kw["preempt_risk"] = np.array([1.0, 0.0], np.float32)
        want = jsc.plan(demand, tick, current, **kw)
        got = tsc.plan(demand, tick, current, **kw,
                       fetch=lambda t: fetched.append(t) or t.numpy())
        np.testing.assert_array_equal(got, want)
        current = want
    assert len(fetched) == 12           # one fetch a plan


# -------------------------------------------------------------- forecaster
def test_forecaster_matches_reference():
    params = jfc.init_forecaster(jax.random.PRNGKey(2), 3, 16, 5)
    tparams = forecaster_from_jax(_np(params), "cpu")
    window = np.random.default_rng(2).standard_normal((4, 12, 3)) \
        .astype(np.float32)
    np.testing.assert_allclose(
        tfc.forecast(tparams, _t(window)).numpy(),
        np.asarray(jfc.forecast(params, jnp.asarray(window))), atol=1e-5,
        rtol=1e-5)
    np.testing.assert_array_equal(
        tfc.last_value_baseline(_t(window), 5).numpy(),
        np.asarray(jfc.last_value_baseline(jnp.asarray(window), 5)))
    np.testing.assert_array_equal(
        tfc.last_value_baseline(_t(window[0]), 8).numpy(),
        np.asarray(jfc.last_value_baseline(jnp.asarray(window[0]), 8)))
    target = np.random.default_rng(3).standard_normal((4, 5, 3)) \
        .astype(np.float32)
    assert float(tfc.forecast_loss(tparams, _t(window), _t(target))) == \
        pytest.approx(float(jfc.forecast_loss(params, jnp.asarray(window),
                                              jnp.asarray(target))),
                      rel=1e-5)


# ------------------------------------------------------------ control plane
class _Backend:
    """A deterministic numpy ``ClusterBackend``: routed arrivals fill
    per-node queues that the replicas drain; enough of the protocol and of
    the metric keys for the plane's forecast -> balance -> scale loop."""

    def __init__(self, n=2, seed=0):
        self.num_nodes = n
        self.rng = np.random.default_rng(seed)
        self.q = np.zeros(n, np.float32)
        self.rep = np.ones(n, np.int32)
        self.fr = np.full(n, 1.0 / n)
        self.m = {}
        self.node_speed = np.asarray([1.0, 1.4][:n] + [1.0] * (n - 2),
                                     np.float32)

    def observe(self, fc):
        cap = self.capacity()
        f = np.broadcast_to(fc[None, :], (self.num_nodes, fc.shape[0]))
        return np.concatenate(
            [(self.q / max(self.q.sum(), 1.0))[:, None],
             np.minimum(self.q / cap, 4.0)[:, None] / 4.0,
             (cap / cap.sum())[:, None], self.up_mask()[:, None], f],
            axis=1).astype(np.float32)

    def up_mask(self):
        return np.ones(self.num_nodes, np.float32)

    def queue_depths(self):
        return self.q.copy()

    def capacity(self):
        return (self.rep * self.node_speed).astype(np.float32)

    def in_flight(self):
        return self.rep.copy()

    def route(self, fr):
        self.fr = np.asarray(fr, np.float64)

    def tick(self, rate):
        arrive = self.rng.poisson(rate * self.fr * 4.0)
        served = np.minimum(self.q + arrive, self.capacity())
        self.q = (self.q + arrive - served).astype(np.float32)
        util = np.clip(self.q / self.capacity(), 0.0, 1.0).astype(np.float32)
        self.m = {"utilization": util, "mean_utilization": float(util.mean()),
                  "response_time": float(self.q.mean() + 1.0),
                  "overload": float((util > 0.9).mean()),
                  "service_rate": float(served.mean() / 4.0) or None,
                  "preempt_risk": np.zeros(self.num_nodes, np.float32)}
        return self.m

    def metrics(self):
        return self.m

    def scale_to(self, target):
        self.rep = np.clip(np.asarray(target, np.int32), 1, 4)


def _run(plane, backend, rates):
    log = []
    for r in rates:
        plane.step(float(r))
        log.append((plane.fractions.copy(), backend.rep.copy()))
    return log


def _planes(seed):
    jcfg, tcfg = _cfgs()
    jrl = jbal.RLBalancer(jcfg, FEAT, seed=seed)
    trl = tbal.RLBalancer(tcfg, FEAT, seed=seed, device="cpu",
                          state=rl_from_jax(_np(jrl.state), "cpu"))

    def make_j(backend):
        return JaxPlane(jcfg, backend, balancer="rl", scaler="gpso",
                        unit_capacity=1.0, rl=jrl, forecast_scale=2.0,
                        seed=seed, init_arrival=2.0)

    def make_t(backend):
        p = ControlPlane(tcfg, backend, balancer="rl", scaler="gpso",
                         unit_capacity=1.0, rl=trl, forecast_scale=2.0,
                         seed=seed, init_arrival=2.0, device="cpu")
        p.scaler.key = JaxKey(jax.random.PRNGKey(seed))
        return p
    return make_j, make_t


@pytest.mark.parametrize("seed", [0, 1])
def test_plane_decisions_and_state_dict_round_trip(seed):
    """The port's plane makes the reference's decisions tick by tick
    (fractions within 1e-6, equal scale targets), and for both packages a
    FRESH plane that loads a mid-run ``state_dict`` continues the exact
    decision stream of the plane it was taken from."""
    rates = np.random.default_rng(seed).uniform(0.5, 4.0, 40)
    make_j, make_t = _planes(seed)
    logs = {}
    for name, make in (("jax", make_j), ("torch", make_t)):
        backend = _Backend(seed=seed)
        plane = make(backend)
        _run(plane, backend, rates[:17])
        snap, twin = plane.state_dict(), copy.deepcopy(backend)
        cont = _run(plane, backend, rates[17:])
        fresh = make(twin)
        fresh.load_state_dict(snap)
        for (fa, ra), (fb, rb) in zip(cont, _run(fresh, twin, rates[17:])):
            np.testing.assert_array_equal(fa, fb)
            np.testing.assert_array_equal(ra, rb)
        logs[name] = cont
    for (fj, rj), (ft, rt) in zip(logs["jax"], logs["torch"]):
        np.testing.assert_allclose(ft, fj, atol=1e-6)
        np.testing.assert_array_equal(rt, rj)
    assert len({tuple(r) for _, r in logs["torch"]}) > 1   # it did scale


def test_plane_counts_its_fetches_and_host_time():
    _, make_t = _planes(0)
    backend = _Backend()
    plane = make_t(backend)
    _run(plane, backend, [2.0] * 11)
    # one fraction fetch a tick, plus the plans at t = 5 and 10
    assert plane.fetches == 11 + 2
    assert plane.fetch_wait >= 0.0 and min(plane.host_s.values()) > 0.0
    # a training plane needs no other accounting: its balancer counts the
    # fetch of each update's losses (RLBalancer.fetches)
    assert ControlPlane(_cfgs()[1], backend, train_rl=True,
                        device="cpu").train_rl
