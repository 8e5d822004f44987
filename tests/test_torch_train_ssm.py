"""The port's training half against the JAX reference, on the CPU: the ssm
(mamba2-1.3b), hybrid (zamba2-2.7b) and audio (whisper-base) families at
their reduced config, with the helpers and tolerances of
tests/test_torch_train_lm.py: ``Model.loss``'s total, ``ce`` and ``aux``
to 1e-5 relative, every gradient leaf to 1e-4 of its largest |g| (of 1e-3
of the tree's largest for a leaf whose gradient is zero but for
rounding), and a gradient for every leaf. The training forward scans
through ``ssd_chunked`` and attends through einsum, as the reference's.
"""
import pytest

from test_torch_train_lm import (  # noqa: F401 (an autouse fixture)
    _check_every_gradient, _check_loss_and_grads, _one_torch_thread)

ARCHS = ["mamba2-1.3b", "zamba2-2.7b", "whisper-base"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    _check_loss_and_grads(arch, False)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_parameter_gets_a_gradient(arch):
    _check_every_gradient(arch)


def test_long_chunk_gradient_is_finite_where_the_references_is_nan():
    """At mamba2's published chunk (256) over 256 steps a head's decay
    passes ~88: the reference's ``segsum_exp`` overflows exp in its masked
    upper triangle, and ``where``'s backward (0 x inf) puts NaNs in its
    gradient. The port masks before the exp: the same loss, finite
    gradients."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.configs import get_config as jax_get_config
    from repro.models import make_model as jax_make_model
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.models.model import make_model

    cut = dict(ssm_chunk=256, num_layers=1)
    jc = dataclasses.replace(jax_get_config("mamba2-1.3b").reduced(), **cut)
    tc = dataclasses.replace(get_config("mamba2-1.3b").reduced(), **cut)
    jm = jax_make_model(jc)
    jparams = jm.init(jax.random.PRNGKey(0), jnp.float32)
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, (1, 256))
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, {"tokens": jnp.asarray(toks, jnp.int32)}),
        has_aux=True))(jparams)
    assert any(np.isnan(g).any() for g in jax.tree.leaves(
        jax.tree.map(np.asarray, grads)))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    (tloss, _), tgrads = tree.value_and_grad(
        lambda p: make_model(tc).loss(
            p, {"tokens": torch.from_numpy(toks.astype(np.int32))}),
        params, has_aux=True)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    for g in tree.leaves(tgrads):
        assert bool(torch.isfinite(g).all())
