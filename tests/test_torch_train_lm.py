"""The port's training half against the JAX reference, on the CPU: the
families of ``models.lm`` (dense, moe, vlm) at their reduced config
(B 2 x S 32), the reference's weights bridged in (``params_from_jax``,
which also maps a gradient tree); tests/test_torch_train_ssm.py holds the
ssm, hybrid and audio families with this file's helpers.

``Model.loss`` gives the reference's total, ``ce`` and ``aux`` to 1e-5
relative, and its gradient every leaf of ``jax.value_and_grad``'s to 1e-4
of that leaf's largest |g| (of 1e-3 of the tree's largest for a leaf
whose gradient is zero but for rounding, such as a key bias, which
shifts every score of a query alike); the MoE archs also at
``reduced_no_drop`` (capacity high enough that no token drops), the
router's and the experts' gradients included. Every leaf gets a finite
gradient, not all zero wherever the reference's is not. The kernels
without a backward refuse to run under grad (``ops``), on the CPU too;
``gcn_layer``'s autograd path trains. tests/test_torch_train_step.py holds
the train step (several steps, accumulation, remat).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_no_drop
from repro.configs import get_config as jax_get_config
from repro.models import make_model as jax_make_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import gcn, tree
from repro_torch.kernels import ops, ref
from repro_torch.models.model import make_model

# one arch a family; the MoE archs again without drops
ARCHS = ["granite-3-8b", "grok-1-314b", "llama4-maverick-400b-a17b",
         "internvl2-2b"]
CASES = [(a, False) for a in ARCHS] + [
    ("grok-1-314b", True), ("llama4-maverick-400b-a17b", True)]
B, S = 2, 32
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # of each leaf's largest |g|
# a leaf whose largest |g| is below this share of the tree's largest has a
# gradient of zero but for rounding: it is held to GRAD_TOL of the floor
NOISE_FLOOR = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small ops: one intra-op thread, so that parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, no_drop):
    jc, tc = jax_get_config(arch), get_config(arch)
    if no_drop:
        return reduced_no_drop(jc), reduced_no_drop(tc)
    return jc.reduced(), tc.reduced()


def _np_batch(c, seed=0, batch=B):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, c.vocab_size, (batch, S)).astype(
        np.int32)}
    if c.family == "vlm":
        b["patch_embeds"] = (rng.standard_normal(
            (batch, c.num_patches, c.d_model)) * 0.1).astype(np.float32)
    if c.family == "audio":
        b["frame_embeds"] = (rng.standard_normal(
            (batch, c.encoder_seq_len, c.d_model)) * 0.1).astype(np.float32)
    return b


def _torch_batch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


@functools.lru_cache(maxsize=None)
def _reference(arch, no_drop):
    """The reference's weights, batch, loss, metrics and gradient."""
    jc, tc = _configs(arch, no_drop)
    jm = jax_make_model(jc, tp=1)
    jparams = jm.init(jax.random.PRNGKey(0), jnp.float32)
    nb = _np_batch(jc)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in nb.items()})
    return (tc, jax.tree.map(np.asarray, jparams), nb, float(loss),
            {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))


@functools.lru_cache(maxsize=None)
def _port(arch, no_drop):
    tc, jparams, nb, *_ = _reference(arch, no_drop)
    m = make_model(tc)
    params = params_from_jax(jparams, "cpu")
    (loss, metrics), grads = tree.value_and_grad(
        lambda p: m.loss(p, _torch_batch(nb)), params, has_aux=True)
    return params, float(loss), {k: float(v) for k, v in metrics.items()}, \
        grads


def _leaf_scales(grads):
    """Each leaf's largest |g|, floored at NOISE_FLOOR of the tree's."""
    scales = [float(g.abs().max()) for g in tree.leaves(grads)]
    return [max(s, NOISE_FLOOR * max(scales)) for s in scales]


def _assert_grads_close(got, want, tol):
    gl, wl = tree.leaves(got), tree.leaves(want)
    assert len(gl) == len(wl)
    for i, (g, w, scale) in enumerate(zip(gl, wl, _leaf_scales(want))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=tol * scale, err_msg=f"leaf {i}")


def _check_loss_and_grads(arch, no_drop):
    _, _, _, loss, metrics, jgrads = _reference(arch, no_drop)
    _, tloss, tmetrics, tgrads = _port(arch, no_drop)
    np.testing.assert_allclose(tloss, loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tmetrics["ce"], metrics["ce"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(tmetrics["aux"], metrics["aux"],
                               rtol=LOSS_RTOL, atol=1e-30)
    if get_config(arch).uses_moe:
        assert tmetrics["aux"] > 0
    _assert_grads_close(tgrads, params_from_jax(jgrads, "cpu"), GRAD_TOL)


def _check_every_gradient(arch):
    """A leaf whose path ran through a kernel without a backward would
    raise (``ops``) or, on a card without the guard, get no gradient."""
    jgrads = params_from_jax(_reference(arch, False)[-1], "cpu")
    params, _, _, grads = _port(arch, False)
    wl = tree.leaves(jgrads)
    noise = NOISE_FLOOR * max(float(w.abs().max()) for w in wl)
    for i, (p, g, w) in enumerate(zip(tree.leaves(params),
                                      tree.leaves(grads), wl)):
        assert g.shape == p.shape, i
        assert bool(torch.isfinite(g).all()), i
        if float(w.abs().max()) > noise:
            assert float(g.abs().max()) > 0, f"leaf {i} of {arch}"


@pytest.mark.parametrize("arch,no_drop", CASES)
def test_loss_and_grads_match_reference(arch, no_drop):
    _check_loss_and_grads(arch, no_drop)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_parameter_gets_a_gradient(arch):
    _check_every_gradient(arch)


def _kernel_inputs():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 2, 2, 16, generator=g)
    k = torch.randn(1, 8, 2, 16, generator=g)
    v = torch.randn(1, 8, 2, 16, generator=g)
    x = torch.randn(1, 8, 2, 4, generator=g)
    a = -torch.rand(1, 8, 2, generator=g)
    bc = torch.randn(1, 8, 3, generator=g)
    pos = torch.full((1,), 7, dtype=torch.int32)
    state = torch.randn(1, 2, 4, 3, generator=g)
    dt = torch.rand(1, 2, generator=g)
    return {
        "flash_attention": (lambda t: ops.flash_attention(t, k, v), q),
        "flash_decode": (lambda t: ops.flash_decode(t, k, v, pos), q[:, 0]),
        "ssd_scan": (lambda t: ops.ssd_scan(t, a, bc, bc, chunk=4)[0], x),
        "ssd_decode": (lambda t: ops.ssd_decode(
            state.clone(), t, dt, a[0, 0], bc[:, :1], bc[:, :1]), x[:, 0]),
    }


@pytest.mark.parametrize("name", ["flash_attention", "flash_decode",
                                  "ssd_scan", "ssd_decode"])
def test_kernels_without_backward_refuse_grad(name):
    fn, t = _kernel_inputs()[name]
    out = fn(t)                                  # nothing requires grad
    with pytest.raises(RuntimeError, match="no backward"):
        fn(t.clone().requires_grad_())
    with torch.no_grad():
        torch.testing.assert_close(fn(t.clone().requires_grad_()), out,
                                   rtol=0, atol=0)


def test_gcn_layer_still_trains():
    """gcn_layer has its backward: under grad it runs (GCNLayer) and its
    weight gradient is autograd's through the plain version."""
    g = torch.Generator().manual_seed(0)
    a_hat = torch.softmax(torch.randn(6, 6, generator=g), -1)
    x = torch.randn(6, 5, generator=g)
    params = {"w": [torch.randn(5, 8, generator=g),
                    torch.randn(8, 3, generator=g)],
              "b": [torch.randn(8, generator=g), torch.randn(3, generator=g)]}
    loss, grads = tree.value_and_grad(
        lambda p: gcn.gcn_apply(p, a_hat, x).square().sum(), params)

    def plain(p):
        h = ref.gcn_layer_ref(a_hat, x, p["w"][0], p["b"][0], relu=True)
        return ref.gcn_layer_ref(a_hat, h, p["w"][1], p["b"][1],
                                 relu=False).square().sum()
    want_loss, want = tree.value_and_grad(plain, params)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=1e-5)
    for a, b in zip(tree.leaves(grads), tree.leaves(want)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
