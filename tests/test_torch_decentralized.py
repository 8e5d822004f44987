"""The port's decentralized layer (single-device half) against the JAX
reference, on the CPU: the five tests of tests/test_decentralized.py,
each also holding the port's values to the reference's on the same numpy
inputs (1e-6): the mixing matrix (exactly), gossip rounds, the
disagreement, top-k compression (inputs without ties in |x|: ``torch.
topk`` and ``jax.lax.top_k`` may order ties differently) and one error-
feedback compression, then the reference's convergence checks on the
port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decentralized as jdec
from repro.core.gcn import make_topology as jax_make_topology
from repro_torch.core.decentralized import (ErrorFeedback, disagreement,
                                            gossip_average, mixing_matrix,
                                            topk_compress)
from repro_torch.core.gcn import make_topology

TOL = dict(rtol=1e-6, atol=1e-6)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("n,kind", [(10, "ring+hub"), (6, "ring")])
def test_mixing_matrix_doubly_stochastic(n, kind):
    W = mixing_matrix(make_topology(n, kind))
    np.testing.assert_array_equal(
        W, jdec.mixing_matrix(jax_make_topology(n, kind)))
    np.testing.assert_allclose(W.sum(0), 1.0, atol=1e-5)
    np.testing.assert_allclose(W.sum(1), 1.0, atol=1e-5)
    assert np.allclose(W, W.T)
    assert (W >= -1e-9).all()


def test_gossip_converges_to_mean():
    n = 8
    W = mixing_matrix(make_topology(n, "ring+hub"))
    x = _normal(0, (n, 16, 4))
    for rounds in (1, 3):
        np.testing.assert_allclose(
            gossip_average({"w": torch.from_numpy(x)}, W,
                           rounds=rounds)["w"].numpy(),
            np.asarray(jdec.gossip_average({"w": jnp.asarray(x)}, W,
                                           rounds=rounds)["w"]), **TOL)
    out = gossip_average({"w": torch.from_numpy(x)}, W, rounds=60)["w"]
    mean = x.mean(axis=0)
    np.testing.assert_allclose(out[0].numpy(), mean, atol=1e-4)
    # preserves the mean exactly (doubly stochastic)
    np.testing.assert_allclose(out.mean(dim=0).numpy(), mean, atol=1e-5)


def test_gossip_disagreement_decays():
    n = 6
    W = mixing_matrix(make_topology(n, "ring"))
    x = _normal(1, (n, 32))
    p = {"w": torch.from_numpy(x), "b": [torch.from_numpy(x[:, :5] * 2)]}
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), p)
    gaps = [disagreement(p)]
    np.testing.assert_allclose(gaps[0], jdec.disagreement(jp), **TOL)
    for _ in range(5):
        p = gossip_average(p, W, rounds=5)
        gaps.append(disagreement(p))
    assert gaps[-1] < 0.05 * gaps[0]


def test_topk_compress_sparsity():
    x = _normal(2, (64, 64))
    assert len(np.unique(np.abs(x))) == x.size          # no ties
    sparse, mask = topk_compress(torch.from_numpy(x), 0.05)
    jsparse, jmask = jdec.topk_compress(jnp.asarray(x), 0.05)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(sparse.numpy(), np.asarray(jsparse))
    kept = int(mask.sum())
    assert kept == int(64 * 64 * 0.05)
    # keeps the largest-magnitude entries
    thresh = np.sort(np.abs(x).ravel())[-kept]
    assert float(sparse[mask > 0].abs().min()) >= thresh - 1e-6


def _noisy_quadratic_errs(use_ef, steps=600, lr=0.05, k=0.05):
    """Coordinate 0 has a small, consistent gradient; the rest carry large
    zero-mean noise. Plain top-k never transmits coordinate 0 (always below
    the noise threshold); EF accumulates it until it crosses."""
    rng = np.random.default_rng(0)
    target = torch.zeros(128)
    target[0] = 1.0
    x = torch.zeros(128)
    ef = ErrorFeedback(k_frac=k)
    resid = ef.init({"x": x})
    for _ in range(steps):
        noise = np.zeros(128, np.float32)
        noise[1:] = rng.normal(0, 5.0, 127)
        g = {"x": (x - target) + torch.from_numpy(noise)}
        if use_ef:
            sparse, resid = ef.compress(g, resid)
        else:
            sparse = {"x": topk_compress(g["x"], k)[0]}
        x = x - lr * sparse["x"]
    return abs(float(x[0]) - 1.0)


def test_error_feedback_recovers_masked_coordinates():
    """One compression equals the reference's; then EF converges on the
    masked coordinate where plain top-k stalls."""
    g = {"a": _normal(3, (40,)), "b": [_normal(4, (8, 5))]}
    r = {"a": _normal(5, (40,)) * 0.1, "b": [_normal(6, (8, 5)) * 0.1]}
    tt = lambda t: jax.tree.map(torch.from_numpy, t)
    jt = lambda t: jax.tree.map(jnp.asarray, t)
    sparse, res = ErrorFeedback(0.1).compress(tt(g), tt(r))
    jsparse, jres = jdec.ErrorFeedback(0.1).compress(jt(g), jt(r))
    for got, want in ((sparse, jsparse), (res, jres)):
        for a, b in zip(jax.tree.leaves(got, is_leaf=torch.is_tensor),
                        jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    err_ef = _noisy_quadratic_errs(True)
    err_plain = _noisy_quadratic_errs(False)
    assert err_ef < 0.2, err_ef
    assert err_plain > 0.8, err_plain  # never updated coordinate 0
