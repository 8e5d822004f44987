"""The int8 KV cache of the port against the reference, in one process.

The port's counterpart of tests/test_kv_quant.py -- the codec's roundtrip
bound, the zero-row scale, the attention fidelity of a quantized cache and
its bytes -- with the port's ``serving.kv_quant`` held to
``repro.serving.kv_quant`` on the same numpy inputs (int8 values and
scales bit for bit: both round half to even). Then the engine: replicas
built with ``cache_dtype="int8"`` (reduced granite-3-8b, the reference's
weights bridged in) give the reference's int8 token streams and clocks,
standalone and fleet-batched, on both backends (the kernel path reads the
pool through ``ops.flash_decode`` over the int8 leaves); the four int8
leaves survive fleet churn (growth, failure, drain, backfill); and ssm and
hybrid replicas refuse the int8 cache as the reference's do.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import make_model as jax_make_model
from repro.serving import ElasticClusterFrontend as JaxElastic
from repro.serving import ReplicaEngine as JaxReplica
from repro.serving import Request as JaxRequest
from repro.serving import kv_quant as jax_kvq
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models.model import make_model
from repro_torch.serving import kv_quant
from repro_torch.serving.elastic import ElasticClusterFrontend
from repro_torch.serving.engine import ReplicaEngine, Request
from test_torch_vlm import _one_torch_thread  # noqa: F401

MAX_SEQ = 64


@pytest.mark.parametrize("seed,scale", [(0, 0.01), (7, 1.0), (42, 100.0),
                                        (99, 3.7)])
def test_quantize_roundtrip_bounded(seed, scale):
    """absmax int8: the roundtrip error is at most absmax / 254 a row, and
    the int8 values and scales equal the reference's."""
    x = np.random.default_rng(seed).standard_normal((4, 64)).astype(
        np.float32) * scale
    q, s = kv_quant.quantize(torch.from_numpy(x))
    jq, js = jax_kvq.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    err = (kv_quant.dequantize(q, s) - torch.from_numpy(x)).abs().max()
    bound = np.abs(x).max(axis=-1) / 254.0 + 1e-7
    assert float(err) <= float(bound.max()) * 1.001


def test_quantize_zero_row_safe():
    q, s = kv_quant.quantize(torch.zeros(2, 8))
    assert float(kv_quant.dequantize(q, s).abs().max()) == 0.0
    assert torch.equal(s, torch.ones(2))


def test_quantize_axis_keyword_matches_reference():
    """``axis=`` is the reference's keyword: over axis -2 of a (2, 3, 4)
    tensor the values stay (2, 3, 4) int8 and the scales are (2, 4), both
    the reference's; dequantize over the same axis gives its result."""
    x = np.random.default_rng(3).standard_normal((2, 3, 4)).astype(
        np.float32)
    q, s = kv_quant.quantize(torch.from_numpy(x), axis=-2)
    jq, js = jax_kvq.quantize(jnp.asarray(x), axis=-2)
    assert q.dtype == torch.int8 and tuple(q.shape) == (2, 3, 4)
    assert tuple(s.shape) == (2, 4)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        kv_quant.dequantize(q, s, axis=-2).numpy(),
        np.asarray(jax_kvq.dequantize(jq, js, axis=-2)))


def test_quant_attention_close_to_exact():
    """Decode attention over a quantized cache written token by token stays
    within 2% of the exact f32 result; the port's dense read, its kernel's
    plain version (``ops.flash_decode`` on int8 leaves) and the
    reference's ``decode_attend_quant`` agree to f32 rounding."""
    B, G, qpg, S, d = 2, 2, 2, 128, 32
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, G, qpg, d)).astype(np.float32)
    ks = rng.standard_normal((64, B, 1, G, d)).astype(np.float32)
    vs = rng.standard_normal((64, B, 1, G, d)).astype(np.float32)
    cache = kv_quant.init_quant_kv_cache(B, S, G, d, device="cpu")
    jcache = jax_kvq.init_quant_kv_cache(B, S, G, d)
    for t in range(64):
        kv_quant.write_kv_quant(cache, torch.from_numpy(ks[t]),
                                torch.from_numpy(vs[t]), t)
        jcache = jax_kvq.write_kv_quant(jcache, jnp.asarray(ks[t]),
                                        jnp.asarray(vs[t]), t)
    for name in cache:
        np.testing.assert_array_equal(cache[name].numpy(),
                                      np.asarray(jcache[name]))
    pos = 63
    qt = torch.from_numpy(q)
    out = kv_quant.decode_attend_quant(qt, cache, pos)
    want = np.asarray(jax_kvq.decode_attend_quant(jnp.asarray(q), jcache,
                                                  pos))
    np.testing.assert_allclose(out.numpy(), want, atol=2e-5, rtol=2e-5)
    kern = ops.flash_decode(qt, cache["k_q"], cache["v_q"],
                            torch.full((B,), pos, dtype=torch.int32),
                            cache["k_s"], cache["v_s"])
    np.testing.assert_allclose(kern.numpy(), want, atol=2e-5, rtol=2e-5)
    k, v = ks[:, :, 0].transpose(1, 0, 2, 3), vs[:, :, 0].transpose(1, 0, 2,
                                                                     3)
    s = np.einsum("bgqh,btgh->bgqt", q, k) / np.sqrt(d)
    p = np.exp(s - s.max(-1, keepdims=True))
    exact = np.einsum("bgqt,btgh->bgqh", p / p.sum(-1, keepdims=True), v)
    rel = np.abs(out.numpy() - exact).max() / np.abs(exact).max()
    assert rel < 0.02, rel


def test_quant_cache_bytes_halved():
    B, S, G, d = 4, 1024, 8, 128
    c = kv_quant.init_quant_kv_cache(B, S, G, d, device="cpu")
    q_bytes = sum(t.numel() * t.element_size() for t in c.values())
    bf16_bytes = 2 * B * S * G * d * 2
    assert q_bytes < 0.6 * bf16_bytes


def test_quant_cache_defaults_to_cuda(monkeypatch):
    """Like every entry point of the port, the int8 cache is made on the
    card unless the caller names the CPU: with no CUDA it raises, never
    moves."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        kv_quant.init_quant_kv_cache(2, 8, 2, 32)
    c = kv_quant.init_quant_kv_cache(2, 8, 2, 32, device="cpu")
    assert {t.device.type for t in c.values()} == {"cpu"}


# ------------------------------------------------------------------ engine
@functools.lru_cache(maxsize=None)
def _pair(name):
    jm = jax_make_model(jax_get_config(name).reduced(), tp=1)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    tm = make_model(get_config(name).reduced(), tp=1)
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _snap(reqs):
    return {r.rid: (tuple(r.output), r.first_token_time, r.finish_time)
            for r in reqs}


def _reqs(cls, seed=3, n=8):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(1, 400, int(rng.integers(3, 30))).tolist(),
                max_new_tokens=int(rng.integers(4, 12))) for i in range(n)]


@functools.lru_cache(maxsize=None)
def _ref_standalone():
    jm, jp, _, _ = _pair("granite-3-8b")
    eng = JaxReplica(jm, jp, max_batch=4, max_seq=MAX_SEQ,
                     cache_dtype="int8")
    reqs = _reqs(JaxRequest)
    for r in reqs:
        eng.submit(r)
    while eng.load:
        eng.step()
    return _snap(reqs)


@pytest.mark.parametrize("backend", ["pallas", "einsum"])
def test_int8_engine_matches_reference(backend):
    """A standalone int8 replica: the port's streams, first-token and
    finish ticks equal the reference's int8 replica's."""
    _, _, tm, tp = _pair("granite-3-8b")
    eng = ReplicaEngine(tm, tp, max_batch=4, max_seq=MAX_SEQ,
                        cache_dtype="int8", attn_backend=backend,
                        device="cpu")
    assert set(eng.cache) == {"k_q", "v_q", "k_s", "v_s"}
    reqs = _reqs(Request)
    for r in reqs:
        eng.submit(r)
    while eng.load:
        eng.step()
    assert _snap(reqs) == _ref_standalone()


def _fleet(elastic, replica, req_cls, fleet, churn, async_tick=True):
    fe = elastic(lambda rid: replica(max_batch=2, max_seq=MAX_SEQ, rid=rid,
                                     cache_dtype="int8"),
                 2, initial_replicas=2, seed=0, fleet_batch=fleet,
                 async_tick=async_tick)
    reqs = _reqs(req_cls, seed=9, n=10)
    for r in reqs:
        fe.submit(r)
    fe.tick(0.0)
    if churn:
        fe.fail_replica(0, 0)
        fe.tick(0.0)
        fe.scale_to(np.array([1, 1]))
        fe.tick(0.0)
        fe.scale_to(np.array([3, 2]))
    fe.run_until_drained()
    return _snap(reqs), fe


@pytest.mark.parametrize("churn", [False, True], ids=["steady", "churn"])
def test_int8_fleet_matches_reference(churn):
    """Fleet-batched int8 replicas (the async tick, one decode dispatch over
    the slab's four int8 leaves): streams and clocks equal the
    reference's int8 fleet, and with churn (a failure, a drain, growth and
    the backfill of removed rows) the port's own per-replica and eager
    oracles."""
    jm, jp, tm, tp = _pair("granite-3-8b")
    port = lambda **kw: ReplicaEngine(tm, tp, device="cpu", **kw)
    got, fe = _fleet(ElasticClusterFrontend, port, Request, True, churn)
    want, _ = _fleet(JaxElastic, lambda **kw: JaxReplica(jm, jp, **kw),
                     JaxRequest, True, churn)
    assert got == want
    assert fe.ledger.balanced()
    group = next(iter(fe._fleets.values()))
    assert set(group.slab) == {"k_q", "v_q", "k_s", "v_s"}
    assert group.slab["k_q"].dtype == torch.int8
    if churn:
        assert got == _fleet(ElasticClusterFrontend, port, Request, False,
                             True)[0]
        assert got == _fleet(ElasticClusterFrontend, port, Request, True,
                             True, async_tick=False)[0]


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_int8_refused_for_ssm_and_hybrid(arch):
    """The ssm and hybrid families keep SSM and conv state in float: an int8
    cache raises, with the reference's message."""
    jm, jp, tm, tp = _pair(arch)
    with pytest.raises(ValueError, match="int8 cache needs an attention KV"):
        JaxReplica(jm, jp, max_batch=2, max_seq=32, cache_dtype="int8")
    with pytest.raises(ValueError, match="int8 cache needs an attention KV"):
        ReplicaEngine(tm, tp, max_batch=2, max_seq=32, cache_dtype="int8",
                      device="cpu")
