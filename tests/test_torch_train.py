"""The control plane's training in the port against the reference, on the
CPU: the GCN layer's gradient, one DDPG update, ``RLBalancer.train_step``
and the GRU forecaster's training.

Weights come from the reference through ``repro_torch.bridge``; batches,
replay contents and gradients from numpy; the forecaster's per-step batch
indices from ``JaxKey`` (the reference's ``jax.random`` draws, split at its
places). Tolerances: the GCN gradient 1e-5 against ``jax.grad`` of the
reference's XLA GCN (its Pallas kernel has no VJP); one update's losses
1e-5 relative and every leaf of the four trees 1e-5 absolute; the
forecaster's losses 1e-5 relative and parameters 1e-5 over 20 Adam steps.
On the card the backward is the ``gcn_layer_bwd`` kernel, held to the plain
version here by ``chip_smoke.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cluster import ClusterConfig as JaxClusterConfig
from repro.core import balancer as jbal
from repro.core import ddpg as jddpg
from repro.core import forecaster as jfc
from repro.core import gcn as jgcn
from repro.workload import generate_trace, make_forecast_dataset
from repro.workload import TraceConfig
from repro_torch.bridge import forecaster_from_jax, rl_from_jax
from repro_torch.configs.paper_cluster import ClusterConfig
from repro_torch.core import balancer as tbal
from repro_torch.core import ddpg as tddpg
from repro_torch.core import forecaster as tfc
from repro_torch.core import gcn as tgcn
from repro_torch.core import tree
from repro_torch.kernels import ops
from test_torch_control import JaxKey

CLUSTER = dict(num_nodes=6, horizon=8, batch_size=32, buffer_size=256)
FEAT = 4 + CLUSTER["horizon"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's ops here are small: one intra-op thread each, so that
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(tree_):
    if dataclasses.is_dataclass(tree_):
        tree_ = dataclasses.asdict(tree_)
    return jax.tree.map(np.asarray, tree_)


def _assert_trees_close(got, want, atol):
    """Every leaf of the port's tree against the reference's (numpy)."""
    gl, wl = tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=atol, rtol=0)


def _gcn_inputs(seed, n, lead, f, widths):
    rng = np.random.default_rng(seed)
    a_hat = jgcn.normalize_adjacency(jgcn.make_topology(n, "ring+hub"))
    x = rng.standard_normal(lead + (n, f)).astype(np.float32)
    dims = [f] + list(widths)
    params = {"w": [(rng.standard_normal((i, o)) / np.sqrt(i))
                    .astype(np.float32) for i, o in zip(dims, dims[1:])],
              "b": [rng.standard_normal(o).astype(np.float32) * 0.1
                    for o in widths]}
    g = rng.standard_normal(lead + (n, widths[-1])).astype(np.float32)
    return a_hat, x, params, g


# ----------------------------------------------------------- GCN gradient
@pytest.mark.parametrize("n,lead,f", [(6, (), 12), (8, (5,), 36),
                                      (16, (3,), 36), (16, (2, 2), 12)])
def test_gcn_gradient_matches_jax_grad(n, lead, f):
    """The whole GCN (two layers, relu between) under autograd -- each
    layer a ``GCNLayer``, its backward the plain version here -- against
    ``jax.grad`` of the reference's ``gcn_apply``: d/dx and every weight
    and bias of <gcn_apply(x), g>."""
    a_hat, x, params, g = _gcn_inputs(n + f, n, lead, f, (64, 64))

    def jloss(p, xx):
        return jnp.sum(jgcn.gcn_apply(p, jnp.asarray(a_hat), xx)
                       * jnp.asarray(g))

    jp = jax.tree.map(jnp.asarray, params)
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))

    tp = jax.tree.map(lambda a: _t(a).requires_grad_(), params)
    tx = _t(x).requires_grad_()
    out = tgcn.gcn_apply(tp, _t(a_hat), tx)
    ops.reset_launches()
    grads = torch.autograd.grad(torch.sum(out * _t(g)),
                                [tx] + tree.leaves(tp))
    assert ops.LAUNCHES["gcn_layer_bwd"] == 0        # no kernel on the CPU
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx),
                               atol=1e-5, rtol=1e-5)
    for got, want in zip(grads[1:], jax.tree.leaves(jgp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("need_dx", [True, False])
def test_gcn_layer_bwd_plain_version_matches_jax_vjp(relu, need_dx):
    """``ops.gcn_layer_bwd`` on CPU tensors (the plain version) against the
    VJP of one reference layer, relu on and off, dX on and off."""
    a_hat, x, params, g = _gcn_inputs(int(relu) + 2 * need_dx, 8, (4,), 36,
                                      (64,))
    w, b = params["w"][0], params["b"][0]

    def layer(xx, ww, bb):
        h = jnp.einsum("nm,...mf->...nf", jnp.asarray(a_hat), xx) @ ww + bb
        return jax.nn.relu(h) if relu else h

    out, vjp = jax.vjp(layer, *map(jnp.asarray, (x, w, b)))
    jdx, jdw, jdb = vjp(jnp.asarray(g))
    tout = ops.gcn_layer(_t(a_hat), _t(x), _t(w), _t(b), relu=relu)
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), atol=1e-5)
    dx, dw, db = ops.gcn_layer_bwd(_t(a_hat), _t(x), _t(w), _t(b), tout,
                                   _t(g), relu=relu, need_dx=need_dx)
    assert (dx is None) != need_dx
    if need_dx:
        np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), atol=1e-5,
                               rtol=1e-5)


def test_gcn_apply_records_only_when_a_gradient_is_needed():
    a_hat, x, params, _ = _gcn_inputs(0, 6, (2,), 12, (16, 16))
    tp = jax.tree.map(_t, params)
    assert tgcn.gcn_apply(tp, _t(a_hat), _t(x)).grad_fn is None
    tw = jax.tree.map(lambda a: _t(a).requires_grad_(), params)
    out = tgcn.gcn_apply(tw, _t(a_hat), _t(x))
    fn = out.grad_fn.next_functions[0][0]        # under gcn_apply's view
    assert type(fn).__name__ == "GCNLayerBackward"
    with torch.no_grad():
        assert tgcn.gcn_apply(tw, _t(a_hat), _t(x)).grad_fn is None


# ------------------------------------------------------------- DDPG step
def _batch(seed, n, batch):
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((batch, n, FEAT)).astype(np.float32)
    nxt = rng.standard_normal((batch, n, FEAT)).astype(np.float32)
    act = rng.dirichlet(np.ones(n), batch).astype(np.float32)
    rew = rng.uniform(-2.0, 0.0, batch).astype(np.float32)
    mask = (rng.random((batch, n)) > 0.2).astype(np.float32)
    return obs, act, rew, nxt, mask


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fused_target", [True, False])
def test_ddpg_update_matches_reference(seed, fused_target):
    """One update from bridged state on one batch: the losses within 1e-5
    relative, every leaf of actor, critic and both targets within 1e-5."""
    jcfg = JaxClusterConfig(**CLUSTER)
    n = jcfg.num_nodes
    state = jddpg.init_ddpg(jax.random.PRNGKey(seed), FEAT, jcfg)
    a_hat = jgcn.normalize_adjacency(jgcn.make_topology(n, jcfg.topology))
    batch = _batch(seed, n, jcfg.batch_size)
    hyper = dict(gamma=jcfg.gamma, tau=jcfg.tau, actor_lr=jcfg.actor_lr,
                 critic_lr=jcfg.critic_lr)
    jtup = (state.actor, state.critic, state.actor_target,
            state.critic_target)
    jout, jm = jddpg.ddpg_update(jtup, jnp.asarray(a_hat),
                                 tuple(map(jnp.asarray, batch)), **hyper)
    ts = rl_from_jax(_np(state), "cpu")
    ttup = (ts.actor, ts.critic, ts.actor_target, ts.critic_target)
    tout, tm = tddpg.ddpg_update(ttup, _t(a_hat), tuple(map(_t, batch)),
                                 fused_target=fused_target, **hyper)
    for k in ("critic_loss", "actor_loss"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5)
    for got, want in zip(tout, jout):
        _assert_trees_close(got, _np(want), atol=1e-5)
    # the step moved every tree (a no-op update would pass the above too)
    for got, before in zip(tout, ttup):
        assert any(not torch.equal(g, b) for g, b in
                   zip(tree.leaves(got), tree.leaves(before)))


def test_clip_by_norm_and_polyak():
    rng = np.random.default_rng(0)
    grads = {"a": [_t(rng.standard_normal((3, 2)).astype(np.float32))],
             "b": _t(rng.standard_normal(4).astype(np.float32) * 10)}
    clipped = tddpg.clip_by_norm(grads)
    norm = float(torch.sqrt(sum(torch.sum(g ** 2)
                                for g in tree.leaves(clipped))))
    assert norm == pytest.approx(1.0, rel=1e-6)
    small = tree.tree_map(lambda g: g * 1e-3, grads)
    for g, s in zip(tree.leaves(tddpg.clip_by_norm(small)),
                    tree.leaves(small)):
        assert torch.equal(g, s)
    mixed = tddpg.polyak(grads, small, 0.25)
    np.testing.assert_allclose(mixed["b"].numpy(),
                               (0.75 * grads["b"] + 0.25 * small["b"])
                               .numpy(), rtol=1e-6)


def test_rl_balancer_train_step_matches_reference():
    """Exploring acts, replay and three train_steps on both packages from
    one seed: the same noise and replay draws (numpy, in the reference's
    order), the same losses and parameters."""
    jcfg, tcfg = JaxClusterConfig(**CLUSTER), ClusterConfig(**CLUSTER)
    jrl = jbal.RLBalancer(jcfg, FEAT, seed=5)
    trl = tbal.RLBalancer(tcfg, FEAT, seed=5, device="cpu",
                          state=rl_from_jax(_np(jrl.state), "cpu"))
    rng = np.random.default_rng(5)
    n = jcfg.num_nodes
    assert trl.train_step() == {} == jrl.train_step()   # buffer too small
    obs = rng.standard_normal((n, FEAT)).astype(np.float32)
    for t in range(jcfg.batch_size + 6):
        up = (rng.random(n) > 0.1).astype(np.float32)
        ja = np.asarray(jrl.act(jnp.asarray(obs), jnp.asarray(up),
                                explore=True))
        ta = trl.act(_t(obs), _t(up), explore=True).numpy()
        np.testing.assert_allclose(ta, ja, atol=1e-6)
        nxt = rng.standard_normal((n, FEAT)).astype(np.float32)
        rew = float(rng.uniform(-2, 0))
        jrl.observe(obs, ja, rew, nxt, up)
        trl.observe(obs, ja, rew, nxt, up)
        obs = nxt
    for _ in range(3):
        jm, tm = jrl.train_step(), trl.train_step()
        assert tm.keys() == jm.keys() == {"critic_loss", "actor_loss"}
        for k in jm:
            assert tm[k] == pytest.approx(jm[k], rel=1e-5)
    assert trl.fetches == 3                # one fetch of the losses a step
    for f in ("actor", "critic", "actor_target", "critic_target"):
        _assert_trees_close(getattr(trl.state, f),
                            _np(getattr(jrl.state, f)), atol=1e-5)


# ------------------------------------------------------------ forecaster
def test_train_forecaster_matches_reference():
    """20 Adam steps from the reference's initial parameters, drawing the
    reference's batch indices (JaxKey): losses within 1e-5 relative,
    parameters within 1e-5."""
    arr = generate_trace(TraceConfig(ticks=260), seed=7,
                         load_scale=1.8)["arrivals"]
    X, Y, _ = make_forecast_dataset(arr, 24, 6)
    key = jax.random.PRNGKey(0)
    jparams, jlosses = jfc.train_forecaster(key, X, Y, 16, steps=20,
                                            batch=32)
    init = jfc.init_forecaster(key, 1, 16, 6)
    tparams, tlosses = tfc.train_forecaster(
        JaxKey(key), X, Y, 16, steps=20, batch=32,
        params=forecaster_from_jax(_np(init), "cpu"), device="cpu")
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[-1] < tlosses[0]
    _assert_trees_close(tparams, _np(jparams), atol=1e-5)
    window = _t(X[:3])
    np.testing.assert_allclose(
        tfc.forecast(tparams, window).detach().numpy(),
        np.asarray(jfc.forecast(jparams, jnp.asarray(X[:3]))), atol=1e-5)
    assert float(tfc.forecast_loss(tparams, window, _t(Y[:3]))) == \
        pytest.approx(float(jfc.forecast_loss(jparams, jnp.asarray(X[:3]),
                                              jnp.asarray(Y[:3]))),
                      rel=1e-5)


def test_train_forecaster_draws_its_own_init_from_a_torch_key():
    from repro_torch.core.gpso import TorchKey
    X = np.random.default_rng(0).uniform(0.5, 1.5, (40, 8, 1)) \
        .astype(np.float32)
    Y = X[:, -2:]
    a = tfc.train_forecaster(TorchKey.from_seed(3, "cpu"), X, Y, 8,
                             steps=5, device="cpu")
    b = tfc.train_forecaster(TorchKey.from_seed(3, "cpu"), X, Y, 8,
                             steps=5, device="cpu")
    assert a[1] == b[1] and len(a[1]) == 5
    for x, y in zip(tree.leaves(a[0]), tree.leaves(b[0])):
        assert torch.equal(x, y)
