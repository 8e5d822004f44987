"""The port's train step on the CPU: three AdamW steps (cosine schedule)
against the reference's jitted ``make_train_step`` from the same bridged
weights and batches, every metric to 1e-4 relative (Adam's first step is
nearly a sign function: a gradient near zero may round to the other sign
and move a weight by ~lr, so the params are not held tighter);
``grad_accum=2`` against 1 (the params after one update, the reference's
5e-5 / 5e-4 of tests/test_models.py); ``remat="full"`` and ``"dots"``
against ``"none"`` (loss and gradients to 1e-6 relative, the gradients of
a leaf relative to its largest); an unknown remat name raises.
``layers.cross_entropy`` equals the reference's (padded vocab columns,
a mask) to 1e-6, and ``make_{prefill,decode}_step`` are the model's own
serving calls. Helpers come from tests/test_torch_train_lm.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import layers as jlayers
from repro.models import make_model as jax_make_model
from repro.models import optim as joptim
from repro.models.model import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import tree
from repro_torch.models import lm
from repro_torch.models.layers import cross_entropy
from repro_torch.models.model import (make_decode_step, make_model,
                                      make_prefill_step, make_train_step)
from repro_torch.models.optim import AdamW, cosine_schedule
import torch
from test_torch_train_lm import (  # noqa: F401 (an autouse fixture)
    _assert_grads_close, _configs, _np_batch, _one_torch_thread,
    _torch_batch)

REMAT_RTOL = 1e-6
STEPS_RTOL = 1e-4        # a few AdamW steps' metrics


@functools.lru_cache(maxsize=None)
def _own_loss_and_grads(arch, remat):
    """The port alone, its own weights (seed 0): (loss, metrics, grads)."""
    c = get_config(arch).reduced()
    m = make_model(c, remat=remat)
    params = m.init(seed=0, device="cpu")
    return tree.value_and_grad(
        lambda p: m.loss(p, _torch_batch(_np_batch(c))), params,
        has_aux=True)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["granite-3-8b", "grok-1-314b",
                                  "zamba2-2.7b", "whisper-base"])
def test_remat_matches_none(arch, remat):
    (loss, metrics), grads = _own_loss_and_grads(arch, "none")
    (rloss, rmetrics), rgrads = _own_loss_and_grads(arch, remat)
    np.testing.assert_allclose(float(rloss), float(loss), rtol=REMAT_RTOL)
    np.testing.assert_allclose(float(rmetrics["aux"]),
                               float(metrics["aux"]), rtol=REMAT_RTOL)
    _assert_grads_close(rgrads, grads, REMAT_RTOL)


def test_unknown_remat_raises():
    c = get_config("granite-3-8b").reduced()
    with pytest.raises(ValueError, match="remat"):
        make_model(c, remat="everything")
    with pytest.raises(ValueError, match="remat"):
        lm.remat_policy("dot")


def test_train_steps_match_reference():
    """Three AdamW steps on three batches from the reference's weights
    (granite-3-8b; every family's loss and gradient are held in
    tests/test_torch_train_{lm,ssm}.py)."""
    jc, tc = _configs("granite-3-8b", False)
    jm = jax_make_model(jc)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    batches = [_np_batch(tc, seed=10 + i) for i in range(3)]
    jopt = joptim.AdamW(lr=joptim.cosine_schedule(1e-3, 1, 3))
    jstep = jax.jit(jax_make_train_step(jm, jopt))
    js = jopt.init(jp)
    topt = AdamW(lr=cosine_schedule(1e-3, 1, 3))
    tstep = make_train_step(make_model(tc), topt)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    ts = topt.init(tp)
    for nb in batches:
        jp, js, jm_ = jstep(jp, js, {k: jnp.asarray(v) for k, v in nb.items()})
        tp, ts, tm = tstep(tp, ts, _torch_batch(nb))
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm_[k]),
                                       rtol=STEPS_RTOL, atol=1e-30,
                                       err_msg=k)


def test_grad_accum_matches_one_step():
    """grad_accum=2 on a batch of 4 updates the params as one step over
    the whole batch (the reference's tolerance)."""
    tc = get_config("granite-3-8b").reduced()
    m = make_model(tc)
    params = m.init(seed=0, device="cpu")
    batch = _torch_batch(_np_batch(tc, seed=1, batch=4))
    opt = AdamW(lr=1e-3)
    outs = [make_train_step(m, opt, grad_accum=ga)(params, opt.init(params),
                                                   batch)
            for ga in (1, 2)]
    for a, b in zip(tree.leaves(outs[0][0]), tree.leaves(outs[1][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-5,
                                   rtol=5e-4)
    np.testing.assert_allclose(float(outs[1][2]["loss"]),
                               float(outs[0][2]["loss"]), rtol=1e-5)
    assert set(outs[1][2]) == {"loss", "ce", "aux", "grad_norm", "lr"}


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 5, 12)).astype(np.float32) * 3
    targets = rng.integers(0, 10, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6) if masked else None
    want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                 10, None if mask is None
                                 else jnp.asarray(mask))
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                        10, None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_prefill_and_decode_steps_wrap_the_model():
    c = get_config("granite-3-8b").reduced()
    m = make_model(c)
    params = m.init(seed=0, device="cpu")
    batch = _torch_batch(_np_batch(c))
    logits, state, pos = make_prefill_step(m, 48)(params, batch)
    want, _, wpos = m.prefill(params, batch, cache_len=48)
    assert torch.equal(logits, want) and torch.equal(pos, wpos)
    tok = logits.argmax(-1, keepdim=True)
    got, _ = make_decode_step(m)(params, state, tok, pos)
    _, wstate, _ = m.prefill(params, batch, cache_len=48)
    assert torch.equal(got, m.decode(params, wstate, tok, pos)[0])
