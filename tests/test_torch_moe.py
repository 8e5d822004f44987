"""The port's MoE layer and MoE models against the JAX reference, in one
process.

``models.moe``: ``moe_apply`` gives the reference's output and aux loss in
f32 (atol/rtol 1e-5) at the reference's two test shapes, drops the same
(row, token, choice) pairs at capacity factor 1.0, equals its dense oracle
where nothing drops, keeps a batch row's output whatever the other rows
hold (capacity is per row: a fleet slab's empty or stale rows cannot
displace a live row's token), and breaks top-k ties as ``jax.lax.top_k``
does.

Models: reduced grok-1-314b (moe_every 1, top-2) and llama4-maverick (one
MoE layer with a shared expert, then one dense layer; top-1), the
reference's weights bridged in (``params_from_jax``, which flattens
llama4's layer groups). Prefill and eight greedy decode steps give the
reference's logits (1e-4 in f32) and token streams on both backends, and
with the int8 KV cache for grok; logits at a position do not depend on
later tokens.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import make_model as jax_make_model
from repro.models import moe as jmoe
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.model import make_model
from test_torch_vlm import _one_torch_thread  # noqa: F401
from test_torch_vlm import assert_config_matches

ARCHS = ["grok-1-314b", "llama4-maverick-400b-a17b"]
MOE_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_LEN = 32
# the reference's two test shapes (tests/test_models.py): (B, S, d, ff,
# capacity factor, shared expert); E 4, top-2
CASES = {"shared_no_drops": (3, 8, 32, 64, 4.0, True),
         "drops": (2, 16, 16, 32, 1.0, False)}
E, K = 4, 2


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@functools.lru_cache(maxsize=None)
def _layer(case, activation="swiglu"):
    B, S, d, ff, cf, shared = CASES[case]
    jp = jmoe.init_moe(jax.random.PRNGKey(0), d, ff, E, jnp.float32, shared,
                       activation)
    x = np.random.default_rng(1).standard_normal((B, S, d)).astype(
        np.float32)
    return jp, _torch_tree(jp), x, cf


def _apply(tp, x, cf, activation="swiglu"):
    return moe.moe_apply(tp, torch.from_numpy(x), num_experts=E, top_k=K,
                         capacity_factor=cf, activation=activation)


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_reference(case, activation):
    jp, tp, x, cf = _layer(case, activation)
    assert ("w_up" in tp) == (activation == "swiglu")
    y, aux = jax.jit(functools.partial(
        jmoe.moe_apply, num_experts=E, top_k=K, capacity_factor=cf,
        activation=activation))(jp, jnp.asarray(x))
    ty, taux = _apply(tp, x, cf, activation)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **MOE_TOL)
    np.testing.assert_allclose(float(taux), float(aux), **MOE_TOL)


def _reference_drops(jp, x, cf):
    """The (row, token, choice) pairs the reference drops: its router,
    ``jax.lax.top_k`` and the cumsum slot rule of ``moe_apply``, in jnp."""
    B, S, _ = x.shape
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    _, top_i = jax.lax.top_k(probs, K)
    C = max(int(np.ceil(S * K / E * cf)), K)
    onehot = jax.nn.one_hot(top_i.reshape(B, S * K), E, dtype=jnp.int32)
    slot = (jnp.cumsum(onehot, axis=1) * onehot).sum(-1) - 1
    b, j = np.nonzero(np.asarray(slot) >= C)
    return {(int(r), int(p) // K, int(p) % K) for r, p in zip(b, j)}


def test_dropped_pairs_are_the_references():
    """At capacity factor 1.0 pairs really drop, the same ones as in the
    reference, and a dropped pair adds nothing to its token's output."""
    jp, tp, x, cf = _layer("drops")
    B, S, _ = x.shape
    _, top_p, top_i = moe.route(tp["router"], torch.from_numpy(x), K)
    C = moe.capacity(S, K, E, cf)
    _, slot = moe.dispatch_slots(top_i, E, C)
    got = {(b, j // K, j % K) for b, j in
           zip(*np.nonzero(slot.numpy() == C))}
    assert got and got == _reference_drops(jp, x, cf)
    # the output is each token's kept choices, gate times expert, and
    # nothing of its dropped ones
    xt = torch.from_numpy(x).reshape(B * S, -1)
    outs = moe._expert_ffn(tp, xt.expand(E, -1, -1).contiguous(), "swiglu")
    want = torch.zeros_like(xt)
    for b in range(B):
        for t in range(S):
            for k in range(K):
                if (b, t, k) not in got:
                    want[b * S + t] += top_p[b, t, k] * \
                        outs[top_i[b, t, k], b * S + t]
    y, _ = _apply(tp, x, cf)
    np.testing.assert_allclose(y.reshape(B * S, -1).numpy(), want.numpy(),
                               **MOE_TOL)


def test_moe_apply_matches_dense_oracle():
    """Where nothing drops (capacity factor E), the capacity dispatch
    equals every expert on every token combined with the top-k gates; the
    port's oracle equals the reference's."""
    jp, tp, x, _ = _layer("shared_no_drops")
    y, aux = _apply(tp, x, float(E))
    want = moe.moe_dense_oracle(tp, torch.from_numpy(x), num_experts=E,
                                top_k=K)
    np.testing.assert_allclose(y.numpy(), want.numpy(), **MOE_TOL)
    jwant = jmoe.moe_dense_oracle(jp, jnp.asarray(x), num_experts=E,
                                  top_k=K)
    np.testing.assert_allclose(want.numpy(), np.asarray(jwant), **MOE_TOL)
    assert float(aux) > 0


@pytest.mark.parametrize("S", [16, 1])
def test_rows_do_not_displace_each_other(S):
    """Capacity is per batch row: a row's output is the same beside a
    zero row and a row of large garbage as alone, with drops (S 16 at
    capacity factor 1.0) and at decode (S 1: C = top-k, nothing drops)."""
    jp, tp, x, cf = _layer("drops")
    x = x[:1, :S]
    alone, _ = _apply(tp, x, cf)
    rng = np.random.default_rng(5)
    batch = np.concatenate([np.zeros_like(x), x, 100.0 *
                            rng.standard_normal(x.shape).astype(np.float32)])
    got, _ = _apply(tp, batch, cf)
    np.testing.assert_allclose(got[1:2].numpy(), alone.numpy(), atol=1e-6,
                               rtol=1e-6)
    if S == 1:
        assert moe.capacity(1, K, E, cf) == K
        _, _, top_i = moe.route(tp["router"], torch.from_numpy(batch), K)
        _, slot = moe.dispatch_slots(top_i, E, K)
        assert int(slot.max()) < K


def test_ranked_top_k_breaks_ties_like_jax():
    """Equal probabilities rank by expert index, as in ``jax.lax.top_k``."""
    probs = np.array([[0.2, 0.3, 0.2, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.4, 0.1]], np.float32)
    val, idx = moe.ranked_top_k(torch.from_numpy(probs), 2)
    jval, jidx = jax.lax.top_k(jnp.asarray(probs), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(val.numpy(), np.asarray(jval))


# ------------------------------------------------------------------ models
@functools.lru_cache(maxsize=None)
def _pair(name, **changes):
    jcfg = dataclasses.replace(jax_get_config(name).reduced(), **changes)
    jm = jax_make_model(jcfg, tp=1)
    jp = jax.jit(jm.init, static_argnums=1)(jax.random.PRNGKey(0),
                                            jnp.float32)
    tm = make_model(dataclasses.replace(get_config(name).reduced(),
                                        **changes), tp=1)
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("name", ARCHS)
def test_config_is_the_references(name):
    for view in (lambda c: c, lambda c: c.reduced()):
        got, want = view(get_config(name)), view(jax_get_config(name))
        assert_config_matches(got, want)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
    red = get_config(name).reduced()
    assert red.num_experts == 4 and red.num_experts_per_tok <= 2


def test_bridge_flattens_layer_groups():
    """llama4 at 4 layers: the reference's two groups (moe_layers,
    dense_layers) become layers 0..3, MoE at 0 and 2, each leaf the
    reference's; the port's own init has the same structure."""
    jm, jp, tm, tp = _pair("llama4-maverick-400b-a17b", num_layers=4)
    assert ["moe" in lp for lp in tp["layers"]] == [True, False, True,
                                                    False]
    for g in range(2):
        np.testing.assert_array_equal(
            tp["layers"][2 * g]["moe"]["w_gate"].numpy(),
            np.asarray(jp["moe_layers"]["moe"]["w_gate"][g]))
        np.testing.assert_array_equal(
            tp["layers"][2 * g + 1]["mlp"]["w_down"].numpy(),
            np.asarray(jp["dense_layers"]["mlp"]["w_down"][g, 0]))
    assert "shared" in tp["layers"][0]["moe"]
    own = tm.init(seed=0, device="cpu")
    shapes = jax.tree.map(lambda t: tuple(t.shape), own["layers"])
    assert shapes == jax.tree.map(lambda t: tuple(t.shape), tp["layers"])


@functools.lru_cache(maxsize=None)
def _jitted(name):
    """The reference's prefill and decode, jitted as its engine runs
    them (eagerly, each decode step would compile its layer scan anew)."""
    jm = _pair(name)[0]
    return (jax.jit(jm.prefill, static_argnames=("cache_len", "cache_dtype")),
            jax.jit(jm.decode))


def _prompts(vocab, seed=2):
    rng = np.random.default_rng(seed)
    return rng.integers(1, vocab, size=(2, 12)).astype(np.int32)


@pytest.mark.parametrize("name,backend,cache", [
    ("grok-1-314b", "pallas", "f32"), ("grok-1-314b", "einsum", "f32"),
    ("llama4-maverick-400b-a17b", "pallas", "f32"),
    ("llama4-maverick-400b-a17b", "einsum", "f32"),
    ("grok-1-314b", "pallas", "int8")])
def test_greedy_streams_match_reference(name, backend, cache):
    """Prefill, then eight greedy decode steps: the reference's logits
    within 1e-4 and its token streams."""
    jm, jp, tm, tp = _pair(name)
    jprefill, jdecode = _jitted(name)
    toks = _prompts(jm.cfg.vocab_size)
    jd = jnp.float32 if cache == "f32" else "int8"
    td = torch.float32 if cache == "f32" else "int8"
    jl, jc, jpos = jprefill(jp, {"tokens": jnp.asarray(toks)},
                            cache_len=CACHE_LEN, cache_dtype=jd)
    tl, tc, tpos = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                              cache_len=CACHE_LEN, cache_dtype=td,
                              attn_backend=backend)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    jtok, ttok = jnp.argmax(jl, axis=-1), torch.argmax(tl, dim=-1)
    js, ts = [np.asarray(jtok)], [ttok.numpy()]
    for _ in range(8):
        jl, jc = jdecode(jp, jc, jtok[:, None].astype(jnp.int32), jpos)
        tl, tc = tm.decode(tp, tc, ttok[:, None].to(torch.int32), tpos,
                           attn_backend=backend)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jpos, tpos = jpos + 1, tpos + 1
        jtok, ttok = jnp.argmax(jl, axis=-1), torch.argmax(tl, dim=-1)
        js.append(np.asarray(jtok))
        ts.append(ttok.numpy())
    np.testing.assert_array_equal(np.stack(ts), np.stack(js))


@pytest.mark.parametrize("name", ARCHS)
def test_future_tokens_do_not_affect_past_logits(name):
    """The causality property of tests/test_causality.py on the port's
    prefill: with the prompt padded to 48 tokens (the same capacity),
    the logits and K/V at position t are unchanged by the tokens after t
    and equal the reference's full forward at t; later positions change."""
    jm, jp, tm, tp = _pair(name)
    B, S, t = 2, 48, 20
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jm.cfg.vocab_size, (B, S)).astype(np.int32)
    toks2 = toks.copy()
    toks2[:, t + 1:] = rng.integers(0, jm.cfg.vocab_size, (B, S - t - 1))
    lens = torch.full((B,), t + 1, dtype=torch.int32)
    outs = [tm.prefill(tp, {"tokens": torch.from_numpy(x), "lengths": lens},
                       cache_len=S, cache_dtype=torch.float32)
            for x in (toks, toks2)]
    np.testing.assert_allclose(outs[0][0].numpy(), outs[1][0].numpy(),
                               atol=1e-5, rtol=1e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(outs[0][1][k][:, :, :t + 1].numpy(),
                                   outs[1][1][k][:, :, :t + 1].numpy(),
                                   atol=1e-5, rtol=1e-5)
    jl, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(outs[0][0].numpy(), np.asarray(jl[:, t]),
                               **TOL)
    full = [tm.prefill(tp, {"tokens": torch.from_numpy(x)}, cache_len=S,
                       cache_dtype=torch.float32)[0] for x in (toks, toks2)]
    assert float((full[0] - full[1]).abs().max()) > 1e-4


@pytest.mark.parametrize("name", ARCHS)
def test_decode_row_ignores_other_slab_rows(name):
    """A decode step's live row gives the same logits beside empty rows
    (zero cache, position 0) and stale ones as alone: a slab's other rows
    cannot take its experts' slots."""
    _, _, tm, tp = _pair(name)
    toks = torch.from_numpy(_prompts(tm.cfg.vocab_size)[:1])
    _, cache, pos = tm.prefill(tp, {"tokens": toks}, cache_len=CACHE_LEN,
                               cache_dtype=torch.float32)
    tok = torch.tensor([[7]], dtype=torch.int32)
    alone, _ = tm.decode(tp, {k: v.clone() for k, v in cache.items()}, tok,
                         pos)
    gen = torch.Generator().manual_seed(3)
    slab = {k: torch.cat([torch.zeros_like(v), v,
                          torch.randn(v.shape, generator=gen)], dim=1)
            for k, v in cache.items()}
    got, _ = tm.decode(tp, slab, torch.tensor([[0], [7], [401]],
                                              dtype=torch.int32),
                       torch.cat([torch.zeros_like(pos), pos, pos + 3]))
    np.testing.assert_allclose(got[1:2].numpy(), alone.numpy(), atol=1e-5,
                               rtol=1e-5)
