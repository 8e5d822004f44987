"""The port's vlm family (internvl2-2b) against the JAX reference, in one
process.

Reduced internvl2-2b (16 patches, d_model 128) on both sides, the
reference's weights bridged in (``params_from_jax``: the stacked layers
plus ``patch_proj``), the same numpy-seeded tokens and patch embeddings,
f32. The patch prefix's prefill and greedy decode give the reference's
logits (atol/rtol 1e-4) on both backends and with the int8 KV cache; the
mirror of tests/test_models.py::test_prefill_decode_consistency holds the
port's prefill and decode to the reference's full forward (2e-4, its own
tolerance); and the port's ``ReplicaEngine`` serving requests that carry
``patch_embeds`` extras gives the reference engine's token streams,
first-token and finish clocks and slot positions, on both backends --
also at a ``max_seq`` where the shared retirement rule, which counts the
patch prefix, stops every request after its first decoded token.

Few distinct prompt lengths: every exact length is a new XLA compile on
the reference's side.
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
from repro.serving import ReplicaEngine as JaxReplica
from repro.serving import Request as JaxRequest
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models.model import make_model
from repro_torch.serving.engine import (FleetGroup, ReplicaEngine, Request,
                                       stage_extras)

ARCH = "internvl2-2b"
TOL = dict(atol=1e-4, rtol=1e-4)
CONSISTENCY_TOL = dict(atol=2e-4, rtol=2e-4)   # tests/test_models.py's
CACHE_LEN = 24                  # + 16 patches: 40 positions, 34 used


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's ops here are small: one intra-op thread each, so that
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def pair(name):
    """(reference model, its params, port model, bridged params), the
    reduced config, f32 weights from PRNGKey(0)."""
    jm = jax_make_model(jax_get_config(name).reduced(), tp=1)
    jp = jax.jit(jm.init, static_argnums=1)(jax.random.PRNGKey(0),
                                            jnp.float32)
    tm = make_model(get_config(name).reduced(), tp=1)
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@functools.lru_cache(maxsize=None)
def jitted(name):
    """The reference's prefill and decode, jitted as its engine runs them."""
    jm = pair(name)[0]
    return (jax.jit(jm.prefill, static_argnames=("cache_len", "cache_dtype")),
            jax.jit(jm.decode))


def extras_of(cfg, n: int, seed: int) -> list:
    """``n`` per-request extras, (1, P, d) patch embeddings or (1, Le, d)
    frames, numpy f32 x 0.1."""
    rng = np.random.default_rng(seed)
    name, length = (("patch_embeds", cfg.num_patches) if cfg.family == "vlm"
                    else ("frame_embeds", cfg.encoder_seq_len))
    return [{name: (0.1 * rng.standard_normal((1, length, cfg.d_model)))
             .astype(np.float32)} for _ in range(n)]


def assert_config_matches(got, want):
    """The port's config holds every field of the reference's with the
    reference's value, and each field only the port has (its own
    families' settings) at its neutral default."""
    mine, theirs = dataclasses.asdict(got), dataclasses.asdict(want)
    assert {k: mine[k] for k in theirs} == theirs
    own = mine.keys() - theirs.keys()
    defaults = {f.name: f.default for f in dataclasses.fields(got)}
    assert {k: mine[k] for k in own} == {k: defaults[k] for k in own}


def check_config(name):
    for view in (lambda c: c, lambda c: c.reduced()):
        got, want = view(get_config(name)), view(jax_get_config(name))
        assert_config_matches(got, want)
        assert got.param_count() == want.param_count()


def greedy_vs_reference(name, batch_np, backend, cache, steps=6):
    """Prefill ``batch_np`` and decode ``steps`` greedy tokens on both
    sides: logits within ``TOL`` at every step, equal positions and
    streams."""
    jm, jp, tm, tp = pair(name)
    jprefill, jdecode = jitted(name)
    jd = jnp.float32 if cache == "f32" else "int8"
    td = torch.float32 if cache == "f32" else "int8"
    jl, jc, jpos = jprefill(jp, {k: jnp.asarray(v) for k, v in
                                 batch_np.items()},
                            cache_len=CACHE_LEN, cache_dtype=jd)
    tl, tc, tpos = tm.prefill(tp, {k: torch.from_numpy(v) for k, v in
                                   batch_np.items()},
                              cache_len=CACHE_LEN, cache_dtype=td,
                              attn_backend=backend)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tpos.numpy(),
                                  np.broadcast_to(np.asarray(jpos),
                                                  tpos.shape))
    jpos = jnp.asarray(tpos.numpy())
    jtok, ttok = jnp.argmax(jl, axis=-1), torch.argmax(tl, dim=-1)
    js, ts = [np.asarray(jtok)], [ttok.numpy()]
    for _ in range(steps):
        jl, jc = jdecode(jp, jc, jtok[:, None].astype(jnp.int32), jpos)
        tl, tc = tm.decode(tp, tc, ttok[:, None].to(torch.int32), tpos,
                           attn_backend=backend)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jpos, tpos = jpos + 1, tpos + 1
        jtok, ttok = jnp.argmax(jl, axis=-1), torch.argmax(tl, dim=-1)
        js.append(np.asarray(jtok))
        ts.append(ttok.numpy())
    np.testing.assert_array_equal(np.stack(ts), np.stack(js))


def consistency_vs_reference(name):
    """tests/test_models.py::test_prefill_decode_consistency's batch
    (``_batch``: tokens from PRNGKey(0), extras from the same key x 0.1;
    B 2, S 32), the port's prefill(S) against the reference's
    ``forward(S)[:, -1]`` and its decode of token S against
    ``forward(S + 1)[:, -1]``, at the reference's 2e-4, on both
    backends. The forward is jitted (the same values as eagerly, at a
    third of the time)."""
    jm, jp, tm, tp = pair(name)
    c = jm.cfg
    key = jax.random.PRNGKey(0)
    B, S = 2, 32
    toks = jax.random.randint(key, (B, S + 1), 0, c.vocab_size)
    batch = {"tokens": toks[:, :S]}
    if c.family == "vlm":
        batch["patch_embeds"] = jax.random.normal(
            key, (B, c.num_patches, c.d_model)) * 0.1
    if c.family == "audio":
        batch["frame_embeds"] = jax.random.normal(
            key, (B, c.encoder_seq_len, c.d_model)) * 0.1
    forward = jax.jit(jm.forward)
    full, _ = forward(jp, batch)
    full2, _ = forward(jp, dict(batch, tokens=toks))
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    nxt = torch.from_numpy(np.array(toks[:, S:S + 1]))
    for backend in ("pallas", "einsum"):
        pre, state, pos = tm.prefill(tp, tb, cache_len=64,
                                     cache_dtype=torch.float32,
                                     attn_backend=backend)
        np.testing.assert_allclose(pre.numpy(), np.asarray(full[:, -1]),
                                   **CONSISTENCY_TOL)
        dec, _ = tm.decode(tp, state, nxt, pos, attn_backend=backend)
        np.testing.assert_allclose(dec.numpy(), np.asarray(full2[:, -1]),
                                   **CONSISTENCY_TOL)


def engine_run(cls, req_cls, model, params, reqs_spec, max_seq, **kw):
    """One standalone replica (max_batch 2) stepped until the four
    requests finish: their (output, first-token, finish) and the slot
    positions after every step."""
    eng = cls(model, params, max_batch=2, max_seq=max_seq, **kw)
    reqs = []
    for rid, prompt, n_new, extras in reqs_spec:
        r = req_cls(rid, list(prompt), max_new_tokens=n_new)
        r.extras = extras
        reqs.append(r)
        eng.submit(r)
    positions = []
    for _ in range(200):
        eng.step()
        positions.append(tuple(int(p) for p, s in zip(eng.pos, eng.slots)
                               if s is not None))
        if all(r.done for r in reqs):
            break
    return ({r.rid: (tuple(r.output), r.first_token_time, r.finish_time)
             for r in reqs}, positions, eng.prefill_traces)


def engine_spec(cfg, lengths, n_new, seed=9):
    rng = np.random.default_rng(seed)
    ex = extras_of(cfg, len(lengths), seed + 1)
    return [(i, rng.integers(1, cfg.vocab_size, ln).tolist(), n, e)
            for i, (ln, n, e) in enumerate(zip(lengths, n_new, ex))]


@functools.lru_cache(maxsize=None)
def reference_engine(name, max_seq, lengths, n_new):
    jm, jp, tm, _ = pair(name)
    return engine_run(JaxReplica, JaxRequest, jm, jp,
                      engine_spec(tm.cfg, lengths, n_new), max_seq,
                      cache_dtype=jnp.float32)


def port_engine(name, max_seq, lengths, n_new, backend):
    _, _, tm, tp = pair(name)
    return engine_run(ReplicaEngine, Request, tm, tp,
                      engine_spec(tm.cfg, lengths, n_new), max_seq,
                      cache_dtype=torch.float32, attn_backend=backend,
                      device="cpu")


# ------------------------------------------------------------------ tests
def test_config_is_the_references():
    check_config(ARCH)
    red = get_config(ARCH).reduced()
    assert (red.num_patches, red.d_model, red.family) == (16, 128, "vlm")


def test_bridge_maps_the_vlm_tree():
    """The stacked layers split one dict per layer; ``patch_proj`` crosses
    as it is; the port's own init has the same structure and shapes."""
    jm, jp, tm, tp = pair(ARCH)
    np.testing.assert_array_equal(tp["patch_proj"].numpy(),
                                  np.asarray(jp["patch_proj"]))
    assert len(tp["layers"]) == jm.cfg.num_layers
    np.testing.assert_array_equal(tp["layers"][1]["attn"]["wq"].numpy(),
                                  np.asarray(jp["layers"]["attn"]["wq"][1]))
    own = tm.init(seed=0, device="cpu")
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(own) == shapes(tp)


@pytest.mark.parametrize("backend,cache", [("pallas", "f32"),
                                           ("einsum", "f32"),
                                           ("pallas", "int8"),
                                           ("einsum", "int8")])
def test_prefix_prefill_and_decode_match_reference(backend, cache):
    """Two rows of 12 tokens after their 16 patches: the reference's
    ``lm_prefill`` / ``lm_decode`` logits and greedy streams; ``pos``
    counts the prefix (28 after prefill); the pool holds CACHE_LEN + 16
    positions a row."""
    _, _, tm, _ = pair(ARCH)
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(1, tm.cfg.vocab_size, (2, 12))
             .astype(np.int32),
             "patch_embeds": (0.1 * rng.standard_normal(
                 (2, tm.cfg.num_patches, tm.cfg.d_model))).astype(np.float32)}
    greedy_vs_reference(ARCH, batch, backend, cache)
    state = tm.init_serve_state(2, CACHE_LEN, "int8" if cache == "int8"
                                else torch.float32, device="cpu")
    assert next(iter(state.values())).shape[2] == CACHE_LEN + 16


def test_prefill_decode_consistency_mirror():
    consistency_vs_reference(ARCH)


def test_prefix_is_attended():
    """Other patches change the first token's logits: the prefix reaches
    the text through attention."""
    _, _, tm, tp = pair(ARCH)
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(1, 400, (1, 6)).astype(np.int32))
    outs = []
    for ex in extras_of(tm.cfg, 2, 5):
        logits, _, pos = tm.prefill(tp, {"tokens": toks, "patch_embeds":
                                         torch.from_numpy(ex["patch_embeds"])},
                                    cache_len=8, cache_dtype=torch.float32)
        outs.append(logits)
        assert int(pos[0]) == tm.cfg.num_patches + 6
    assert (outs[0] - outs[1]).abs().max() > 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage_extras_casts_to_the_weights_dtype(dtype):
    """``stage_extras`` puts a numpy extra and a tensor extra on the device
    in the weights' dtype, values kept up to that dtype's rounding, the
    caller's arrays untouched."""
    ex = extras_of(get_config(ARCH).reduced(), 1, 7)[0]["patch_embeds"]
    src = {"patch_embeds": ex, "frame_embeds": torch.from_numpy(ex.copy())}
    got = stage_extras(src, torch.device("cpu"), dtype)
    assert set(got) == set(src)
    for t in got.values():
        assert t.dtype == dtype and t.shape == ex.shape
        np.testing.assert_array_equal(
            t.float().numpy(), torch.from_numpy(ex).to(dtype).float().numpy())
    assert src["patch_embeds"] is ex


@pytest.mark.parametrize("backend", ["pallas", "einsum"])
def test_engine_with_extras_matches_reference(backend):
    """Four requests carrying ``patch_embeds`` through a standalone
    replica of 2 slots and max_seq 64 (a pool of 64 + 16 positions):
    the reference engine's streams, clocks and per-step slot positions
    (which count the prefix), and its count of prefill shapes."""
    args = (ARCH, 64, (5, 7, 5, 7), (6, 4, 9, 3))
    assert port_engine(*args, backend) == reference_engine(*args)


def test_engine_retires_at_the_prefix_inclusive_max_seq():
    """The reference's retirement counts the patch prefix: at max_seq 20
    a request of 16 patches and 5-7 tokens starts its decode at pos 21-23,
    past ``max_seq - 1``, so it stops after its first decoded token,
    whatever its budget -- on both engines alike."""
    args = (ARCH, 20, (5, 7, 5, 7), (6, 4, 9, 3))
    got = port_engine(*args, "pallas")
    assert got == reference_engine(*args)
    assert all(len(out) == 2 for out, _, _ in got[0].values())


def test_fleet_and_cli_refuse_vlm():
    """A fleet of vlm replicas serves (its parity with the reference's
    fleet run is tests/test_torch_fleet_extras.py): a member's slab rows
    hold max_seq + num_patches positions. The CLI still refuses the
    family, as the reference's CLI fails on it, with the pointer to the
    engine API; chunked prefill raises as in the reference."""
    _, _, tm, tp = pair(ARCH)
    g = FleetGroup(tm, tp, max_batch=2, max_seq=32, device="cpu")
    g.add(ReplicaEngine(tm, tp, max_batch=2, max_seq=32, device="cpu"))
    assert g.slab["k"].shape[1:3] == (2, 32 + tm.cfg.num_patches)
    with pytest.raises(SystemExit, match="Request.extras"):
        serve.main(["--device", "cpu", "--arch", ARCH, "--requests", "2"])
    with pytest.raises(ValueError, match="chunked prefill unsupported"):
        tm.prefill_chunk(tp, {}, None, None, None)
