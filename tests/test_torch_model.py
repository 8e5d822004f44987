"""The port's dense model against the JAX ``Model`` on the same weights.

Reduced granite-3-8b and qwen2.5-14b (the latter covers the QKV-bias
branch; its biases are set to random values, since init leaves them zero).
The reference's params go through ``repro_torch.bridge.params_from_jax``,
prompts come from numpy, and both backends of the port (the kernels'
plain versions on the CPU, and the einsum path) must give the reference's
prefill logits and filled cache, decode logits and cache within 1e-4 in
f32, and the same greedy streams.
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
from repro_torch.models.model import make_model
from test_torch_vlm import _one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_LEN = 32


@pytest.fixture(scope="module", params=["granite-3-8b", "qwen2.5-14b"])
def pair(request):
    name = request.param
    jm = jax_make_model(jax_get_config(name).reduced(), tp=1)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                            jnp.float32))
    rng = np.random.default_rng(1)
    attn = tree["layers"]["attn"]
    for b in ("bq", "bk", "bv"):
        if b in attn:
            attn[b] = (0.1 * rng.standard_normal(attn[b].shape)) \
                .astype(np.float32)
    tm = make_model(get_config(name).reduced(), tp=1)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jm, jparams, tm, params_from_jax(tree, device="cpu")


def _prompts(vocab, seed=2):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, size=(2, 12)).astype(np.int32)
    return toks, np.array([12, 7], np.int32)


def _prefill_both(pair, backend):
    jm, jp, tm, tp = pair
    toks, lens = _prompts(jm.cfg.vocab_size)
    jl, jc, jpos = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                                   "lengths": jnp.asarray(lens)},
                              cache_len=CACHE_LEN, cache_dtype=jnp.float32)
    tl, tc, tpos = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                                   "lengths": torch.from_numpy(lens)},
                              cache_len=CACHE_LEN, cache_dtype=torch.float32,
                              attn_backend=backend)
    return (jl, jc, jpos), (tl, tc, tpos)


@pytest.mark.parametrize("backend", ["pallas", "einsum"])
def test_prefill_matches_reference(pair, backend):
    (jl, jc, jpos), (tl, tc, tpos) = _prefill_both(pair, backend)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


@pytest.mark.parametrize("backend", ["pallas", "einsum"])
def test_decode_matches_reference(pair, backend):
    """One decode step at per-row positions over the filled caches."""
    jm, jp, tm, tp = pair
    (jl, jc, jpos), (tl, tc, tpos) = _prefill_both(pair, backend)
    tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
    jl2, jc2 = jm.decode(jp, jc, jnp.asarray(tok), jpos)
    tl2, tc2 = tm.decode(tp, tc, torch.from_numpy(tok), tpos,
                         attn_backend=backend)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc2[name].numpy(), np.asarray(jc2[name]),
                                   **TOL)


@pytest.mark.parametrize("backend", ["pallas", "einsum"])
def test_greedy_streams_match_reference(pair, backend):
    """Eight greedy steps after the prefill: identical token streams."""
    jm, jp, tm, tp = pair
    (jl, jc, jpos), (tl, tc, tpos) = _prefill_both(pair, backend)
    jtok, ttok = jnp.argmax(jl, axis=-1), torch.argmax(tl, dim=-1)
    js, ts = [np.asarray(jtok)], [ttok.numpy()]
    for _ in range(8):
        jl, jc = jm.decode(jp, jc, jtok[:, None].astype(jnp.int32), jpos)
        tl, tc = tm.decode(tp, tc, ttok[:, None].to(torch.int32), tpos,
                           attn_backend=backend)
        jpos, tpos = jpos + 1, tpos + 1
        jtok, ttok = jnp.argmax(jl, axis=-1), torch.argmax(tl, dim=-1)
        js.append(np.asarray(jtok))
        ts.append(ttok.numpy())
    np.testing.assert_array_equal(np.stack(ts), np.stack(js))


def test_unported_family_raises():
    """Every family of the reference builds (vlm and audio since they were
    ported: tests/test_torch_vlm.py, tests/test_torch_audio.py); a family
    the port does not know raises."""
    for name in ("internvl2-2b", "whisper-base"):
        make_model(get_config(name).reduced())
    cfg = dataclasses.replace(get_config("granite-3-8b").reduced(),
                              family="retrieval")
    with pytest.raises(ValueError, match="not yet ported"):
        make_model(cfg)


def test_bridge_keeps_bf16_weights_bit_exact():
    """bf16 leaves (numpy's ml_dtypes bfloat16) cross as torch.bfloat16
    with the same bits, and stacked layers split per layer."""
    jm = jax_make_model(jax_get_config("granite-3-8b").reduced(), tp=1)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3),
                                            jnp.bfloat16))
    tp = params_from_jax(tree, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["embed"].float().numpy(),
                                  tree["embed"].astype(np.float32))
    wq = tree["layers"]["attn"]["wq"]
    assert len(tp["layers"]) == wq.shape[0]
    for i, lp in enumerate(tp["layers"]):
        np.testing.assert_array_equal(lp["attn"]["wq"].float().numpy(),
                                      wq[i].astype(np.float32))
