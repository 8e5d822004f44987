"""The balancer's whole greedy action (``ops.gcn_actor``, its plain version
``ref.gcn_actor_ref``, and ``RLBalancer`` on its fused and layered paths)
against the JAX package, in one process.

The reference's actor weights come from ``repro.core.ddpg.init_ddpg`` and
carry across through ``repro_torch.bridge``; its head's last layer starts at
1/100 scale, so the tests scale it up (on both sides) and give every bias a
value, to make the logits O(1) and the softmax far from uniform. Observations,
masks and noise come from numpy with a seed. Tolerance 1e-6, as
tests/test_torch_control.py holds the actor.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cluster import ClusterConfig as JaxClusterConfig
from repro.core import balancer as jbal
from repro.core import ddpg as jddpg
from repro.core import gcn as jgcn
from repro_torch.bridge import rl_from_jax
from repro_torch.configs.paper_cluster import ClusterConfig
from repro_torch.core import balancer as tbal
from repro_torch.core import ddpg as tddpg
from repro_torch.kernels import gcn_fused, ops, ref
from test_torch_control import CLUSTER, FEAT, _np, _t

CLOSE = dict(atol=1e-6, rtol=1e-6)


def _lively(actor: dict, seed: int) -> dict:
    """The reference's actor (as numpy) with its head's last layer at full
    scale and every bias drawn, so the logits differ by O(1) between
    nodes."""
    rng = np.random.default_rng(seed)
    actor = jax.tree.map(np.asarray, actor)
    gcn, head = actor["gcn"], actor["head"]

    def bias(b):
        return (0.1 * rng.standard_normal(b.shape)).astype(np.float32)
    gcn["b"] = [bias(b) for b in gcn["b"]]
    head["b1"], head["b2"] = bias(head["b1"]), bias(head["b2"])
    head["w2"] = head["w2"] * np.float32(100.0)
    return actor


@pytest.fixture(scope="module")
def actors():
    """n -> (the reference's lively actor (numpy), a_hat (numpy))."""
    out = {}
    for n in (2, 5, 16):
        jcfg = JaxClusterConfig(**{**CLUSTER, "num_nodes": n})
        state = jddpg.init_ddpg(jax.random.PRNGKey(n), FEAT, jcfg)
        out[n] = (_lively(state.actor, n), jgcn.normalize_adjacency(
            jgcn.make_topology(n, jcfg.topology)))
    return out


def _torch_actor(actor: dict) -> dict:
    return rl_from_jax({"actor": actor, "critic": {}, "actor_target": {},
                        "critic_target": {}}, "cpu").actor


def _mask(kind: str, shape: tuple):
    if kind == "none":
        return None
    up = np.ones(shape, np.float32)
    if kind == "one":
        up[..., 0] = 0.0               # the hub node is down
    else:
        up[:] = 0.0                    # every node down: the uniform split
    return up


@pytest.mark.parametrize("noise", [False, True], ids=["greedy", "noise"])
@pytest.mark.parametrize("mask", ["none", "one", "all"])
@pytest.mark.parametrize("lead", [(), (3,)], ids=["obs", "batch3"])
@pytest.mark.parametrize("n", [2, 5, 16])
def test_gcn_actor_ref_matches_reference(actors, n, lead, mask, noise):
    actor, a_hat = actors[n]
    rng = np.random.default_rng(n + 10 * len(lead))
    obs = rng.standard_normal(lead + (n, FEAT)).astype(np.float32)
    up = _mask(mask, lead + (n,))
    nz = rng.standard_normal(lead + (n,)).astype(np.float32) if noise \
        else None
    want = np.asarray(jddpg.actor_action(
        actor, jnp.asarray(a_hat), jnp.asarray(obs),
        up_mask=None if up is None else jnp.asarray(up),
        noise=None if nz is None else jnp.asarray(nz)))
    ta = _torch_actor(actor)
    got = ref.gcn_actor_ref(_t(a_hat), _t(obs), ta["gcn"], ta["head"],
                            up_mask=None if up is None else _t(up),
                            noise=None if nz is None else _t(nz)).numpy()
    np.testing.assert_allclose(got, want, **CLOSE)
    assert got.shape == lead + (n,)
    np.testing.assert_allclose(got.sum(axis=-1), 1.0, atol=1e-6)
    if mask == "one":
        assert np.all(got[..., 0] == 0.0)
    elif mask == "all":
        np.testing.assert_allclose(got, 1.0 / n, atol=1e-7)
    else:
        assert np.ptp(got) > 1e-2         # the logits are not all alike


@pytest.mark.parametrize("lead,rows", [((), "obs"), ((3,), "obs"),
                                       ((3,), "shared")])
def test_ops_gcn_actor_takes_plain_path_on_cpu(actors, lead, rows):
    """On CPU tensors the wrapper is the plain version, exactly, and counts
    no launch; up_mask and noise may be one row for every observation."""
    actor, a_hat = actors[5]
    ta = _torch_actor(actor)
    rng = np.random.default_rng(1)
    obs = _t(rng.standard_normal(lead + (5, FEAT)).astype(np.float32))
    shape = lead + (5,) if rows == "obs" else (5,)
    up = _t(_mask("one", shape))
    nz = _t(rng.standard_normal(shape).astype(np.float32))
    ops.reset_launches()
    got = ops.gcn_actor(_t(a_hat), obs, ta["gcn"], ta["head"], up_mask=up,
                        noise=nz)
    assert ops.LAUNCHES["gcn_layer"] == 0
    assert got.shape == lead + (5,)
    torch.testing.assert_close(got, ref.gcn_actor_ref(
        _t(a_hat), obs, ta["gcn"], ta["head"], up_mask=up, noise=nz),
        rtol=0, atol=0)
    # the layered path (GCN layers through ops.gcn_layer, eager head)
    # computes the same function
    torch.testing.assert_close(tddpg.actor_action(
        ta, _t(a_hat), obs, up_mask=up, noise=nz, fused=False), got,
        **CLOSE)


@pytest.mark.parametrize("f,n_max", [(12, 144), (36, 126)],
                         ids=["serve", "paper"])
def test_gcn_actor_fits_at_its_boundary(f, n_max):
    """The largest graph one block holds (A_hat, X, the layers' outputs,
    every weight) at gcn_hidden 64, actor_hidden 128 and two layers, for
    the serve path's features (horizon 8) and the paper's (horizon 32)."""
    assert ops.gcn_actor_fits(n_max, f, 64, 128)
    assert not ops.gcn_actor_fits(n_max + 1, f, 64, 128)
    assert gcn_fused.smem_bytes(n_max, [f, 64, 64], 128) \
        <= gcn_fused.MAX_SMEM < gcn_fused.smem_bytes(n_max + 1, [f, 64, 64],
                                                      128)
    assert ops.gcn_actor_fits(2, f, 64, 128, n_layers=gcn_fused.MAX_LAYERS)
    assert not ops.gcn_actor_fits(2, f, 64, 128,
                                  n_layers=gcn_fused.MAX_LAYERS + 1)


@pytest.mark.parametrize("n,layered,actor", [
    (2, False, "fused"), (2, True, "layered"), (144, False, "fused"),
    (145, False, "layered")])
def test_rl_balancer_picks_its_path_once_by_n(n, layered, actor):
    cfg = ClusterConfig(**{**CLUSTER, "num_nodes": n})
    rl = tbal.RLBalancer(cfg, FEAT, seed=0, device="cpu", layered=layered)
    assert rl.actor == actor
    obs = torch.randn(n, FEAT, generator=torch.Generator().manual_seed(n))
    fr = rl.act(obs, torch.ones(n))
    assert fr.shape == (n,) and abs(float(fr.sum()) - 1.0) < 1e-5


@pytest.mark.parametrize("explore", [False, True], ids=["greedy", "explore"])
@pytest.mark.parametrize("layered", [False, True], ids=["fused", "layered"])
@pytest.mark.parametrize("n", [2, 16])
def test_rl_balancer_act_matches_reference_on_both_paths(n, layered,
                                                         explore):
    """Three actions in a row (the exploration noise advances the numpy
    generator on both sides), a node down in the second."""
    cfg = {**CLUSTER, "num_nodes": n}
    jrl = jbal.RLBalancer(JaxClusterConfig(**cfg), FEAT, seed=n)
    jrl.state.actor = jax.tree.map(jnp.asarray, _lively(jrl.state.actor, n))
    trl = tbal.RLBalancer(ClusterConfig(**cfg), FEAT, seed=n, device="cpu",
                          state=rl_from_jax(_np(jrl.state), "cpu"),
                          layered=layered)
    assert trl.actor == ("layered" if layered else "fused")
    rng = np.random.default_rng(n)
    for step in range(3):
        obs = rng.standard_normal((n, FEAT)).astype(np.float32)
        up = _mask("one" if step == 1 else "none", (n,))
        up = np.ones(n, np.float32) if up is None else up
        want = np.asarray(jrl.act(jnp.asarray(obs), jnp.asarray(up),
                                  explore=explore))
        got = trl.act(_t(obs), _t(up), explore=explore).numpy()
        np.testing.assert_allclose(got, want, **CLOSE)
