"""The two dense configs added to the port, mistral-nemo-12b and
command-r-35b, against the reference's, in one process.

The configs are the reference's field for field (full and reduced), and
each field only the port has holds its neutral default. The
reduced configs' control loop (``--arch <name> --policy ours --autoscale
gpso``) gives the reference's streams, finish clocks, ledger and per-tick
counts. mistral-nemo-12b's query width (32 heads x 128 = 4096) is not its
d_model (5120), which the reduced config (4 x 32 = 128 = d_model) hides: a
reduced config with d_model 96 keeps the mismatch, and its prefill and
decode logits match the reference's within 1e-4 in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import make_model as jax_make_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models.model import make_model
from test_torch_control_loop import (assert_loops_match, port_loop,
                                     reference_loop)
from test_torch_vlm import _one_torch_thread  # noqa: F401
from test_torch_vlm import assert_config_matches

ARCHS = ["mistral-nemo-12b", "command-r-35b"]
TOL = dict(atol=1e-4, rtol=1e-4)


def _pair(cfg_of):
    jm = jax_make_model(cfg_of(jax_get_config), tp=1)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    tm = make_model(cfg_of(get_config), tp=1)
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("name", ARCHS)
def test_config_is_the_references(name):
    for view in (lambda c: c, lambda c: c.reduced()):
        got, want = view(get_config(name)), view(jax_get_config(name))
        assert_config_matches(got, want)
        assert got.param_count() == want.param_count()


def test_query_width_other_than_d_model_matches_reference():
    """q heads x head_dim != d_model: the projections keep (d_model, heads,
    head_dim), and prefill and decode logits are the reference's."""
    jm, jp, tm, tp = _pair(lambda get: dataclasses.replace(
        get("mistral-nemo-12b").reduced(), d_model=96))
    assert tp["layers"][0]["attn"]["wq"].shape[0] == 96
    assert tm.cfg.num_heads * tm.cfg.resolved_head_dim == 128
    rng = np.random.default_rng(2)
    toks = rng.integers(1, 512, size=(2, 12)).astype(np.int32)
    lens = np.array([12, 7], np.int32)
    jl, jc, jpos = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                                   "lengths": jnp.asarray(lens)},
                              cache_len=32, cache_dtype=jnp.float32)
    tl, tc, tpos = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                                   "lengths": torch.from_numpy(lens)},
                              cache_len=32, cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
    jl2, _ = jm.decode(jp, jc, jnp.asarray(tok), jpos)
    tl2, _ = tm.decode(tp, tc, torch.from_numpy(tok), tpos)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_control_loop_matches_reference(name):
    jm, jp, tm, tp = _pair(lambda get: get(name).reduced())
    args = serve.build_parser().parse_args(
        ["--device", "cpu", "--policy", "ours", "--autoscale", "gpso",
         "--ticks", "15", "--arch", name])
    ref = reference_loop(jm, jp, args)
    out = port_loop(tm, tp, args, ref)
    assert_loops_match(out, ref)
    assert out["fe"].ledger.balanced()
