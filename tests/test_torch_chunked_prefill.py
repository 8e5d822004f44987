"""Chunked prefill of the port against the reference, in one process.

The port's counterpart of tests/test_chunked_prefill.py, with the
reference's engine run beside the port's on the same prompts and the
reference's weights bridged in (reduced granite-3-8b, mamba2-1.3b and
zamba2-2.7b, f32): chunk-by-chunk equals single-shot on both backends and
equals the reference's chunked run; a mid-chunk slot is held out of
decode; TTFT spreads over ceil(len / chunk) ticks; fleet admission keeps
its dispatch bound; chunked admission survives fleet churn; a non-f32
cache drops ``chunk_len`` as the reference does; the prefill-shape count
equals the reference's retrace count. Also the async chunk parity of
tests/test_async_serve.py, the two tier rules of tests/test_slo_tiers.py,
and the control loop under ``--chunk-len 8 --max-seq 64``, whose digest
and per-tick dispatch and sync counts must equal the reference's. Token
streams and clocks compare exactly (greedy argmax over f32 logits).
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
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import make_model
from repro_torch.serving.elastic import ElasticClusterFrontend
from repro_torch.serving.engine import ReplicaEngine, Request
from repro_torch.workload.trace import TierSet, TierSpec
from test_torch_control_loop import (assert_loops_match,
                                     cached_reference_loop, port_loop)
from test_torch_vlm import _one_torch_thread  # noqa: F401

MAX_SEQ = 64
CHUNK = 8
ARCHS = ["granite-3-8b", "mamba2-1.3b", "zamba2-2.7b"]
TIERS = TierSet([TierSpec("premium", share=0.25, weight=5.0,
                          ttft_target=4.0),
                 TierSpec("standard", share=0.5, weight=2.0),
                 TierSpec("batch", share=0.25, weight=1.0)])


@functools.lru_cache(maxsize=None)
def _weights(name):
    jp = jax_make_model(jax_get_config(name).reduced(), tp=1).init(
        jax.random.PRNGKey(0), jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _pair(name):
    """Fresh model objects (each keeps its own count of prefill shapes, and
    the reference's its own compiled kernels) over cached weights."""
    jp, tp = _weights(name)
    return (jax_make_model(jax_get_config(name).reduced(), tp=1), jp,
            make_model(get_config(name).reduced(), tp=1), tp)


# one model pair a name for the tests that compare streams only (the
# reference's compiled kernels are reused across them)
_shared = functools.lru_cache(maxsize=None)(_pair)


def _port(name, **kw):
    _, _, tm, tp = _shared(name)
    return ReplicaEngine(tm, tp, device="cpu", **kw)


def _ref(name, **kw):
    jm, jp, _, _ = _shared(name)
    return JaxReplica(jm, jp, **kw)


def _reqs(cls, lens, n_new=5, seed=5, vocab=400):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(1, vocab, L).tolist(), max_new_tokens=n_new)
            for i, L in enumerate(lens)]


def _snap(reqs):
    return {r.rid: (tuple(r.output), r.first_token_time, r.finish_time)
            for r in reqs}


def _drain(eng, reqs, steps=200):
    for r in reqs:
        eng.submit(r)
    for _ in range(steps):
        eng.step()
        if eng.load == 0:
            break
    assert eng.load == 0
    return _snap(reqs)


# ------------------------------------------------- chunked vs single-shot
LENS = [CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK, 2 * CHUNK + 1, 30,
        MAX_SEQ + 13]          # the last truncates to max_seq - 1


@functools.lru_cache(maxsize=None)
def _ref_chunked(name):
    return _drain(_ref(name, max_batch=4, max_seq=MAX_SEQ, chunk_len=CHUNK),
                  _reqs(JaxRequest, LENS))


@pytest.mark.parametrize("backend", ["pallas", "einsum"])
@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_matches_single_shot(arch, backend):
    """Prompt lengths straddling chunk boundaries (C +- 1, multiples) and
    the max_seq - 1 truncation edge: the port's chunked token streams equal
    its single-shot ones, and its chunked run equals the reference's
    (outputs, first-token and finish ticks)."""
    def run(chunk_len):
        return _drain(_port(arch, max_batch=4, max_seq=MAX_SEQ,
                            chunk_len=chunk_len, attn_backend=backend),
                      _reqs(Request, LENS))

    chunked, single = run(CHUNK), run(0)
    assert {r: v[0] for r, v in chunked.items()} == \
        {r: v[0] for r, v in single.items()}
    assert chunked == _ref_chunked(arch)


def test_chunking_does_not_perturb_concurrent_decode():
    """While a long prompt streams in chunks, a short request sharing the
    engine decodes every tick with its state untouched (the held slot is
    not written): stream and finish tick match a solo run, and the
    reference's."""
    rng = np.random.default_rng(11)
    long_prompt = rng.integers(1, 400, 40).tolist()
    short_prompt = rng.integers(1, 400, 4).tolist()

    def run(eng, cls, with_long):
        short = cls(0, list(short_prompt), max_new_tokens=8)
        reqs = [short] + ([cls(1, list(long_prompt), max_new_tokens=4)]
                          if with_long else [])
        _drain(eng, reqs, 60)
        return short.output, short.finish_time

    kw = dict(max_batch=2, max_seq=MAX_SEQ, chunk_len=CHUNK)
    port = run(_port("granite-3-8b", **kw), Request, True)
    assert port == run(_port("granite-3-8b", **kw), Request, False)
    assert port == run(_ref("granite-3-8b", **kw), JaxRequest, True)


def test_chunked_ttft_spreads_over_ticks():
    """A chunked long prompt produces its first token after ceil(len / C)
    engine steps."""
    plen = 3 * CHUNK + 2           # 4 chunks
    req = Request(0, np.random.default_rng(0).integers(1, 400,
                                                       plen).tolist(),
                  max_new_tokens=3)
    eng = _port("granite-3-8b", max_batch=2, max_seq=MAX_SEQ,
                chunk_len=CHUNK)
    _drain(eng, [req], 30)
    assert req.done
    assert req.first_token_time == pytest.approx(4.0)
    assert eng.prefill_dispatches == 4


# ------------------------------------------------- fleet-batched admission
def test_fleet_prefill_parity_and_dispatch_bound():
    """4 same-model replicas across 2 nodes: same-bucket admits collapse to
    one prefill dispatch per distinct (kb, sb) shape, with streams and
    finish ticks identical to per-replica admission and to the
    reference's, and the reference's dispatch counts."""
    jm, jp, tm, tp = _pair("granite-3-8b")

    def run(elastic, replica, req_cls, fp, **kw):
        fe = elastic(lambda rid: replica(max_batch=2, max_seq=MAX_SEQ,
                                         rid=rid, **kw),
                     2, initial_replicas=2, seed=0, fleet_prefill=fp)
        reqs = _reqs(req_cls, [6] * 8, n_new=4, seed=2)
        for r in reqs:
            fe.submit(r)
        mtr = fe.tick(0.0)
        fe.run_until_drained()
        return _snap(reqs), mtr["prefill_dispatches"], fe.prefill_dispatches()

    port = lambda **kw: ReplicaEngine(tm, tp, device="cpu", **kw)
    ref = lambda **kw: JaxReplica(jm, jp, **kw)
    s_on, m_on, t_on = run(ElasticClusterFrontend, port, Request, True)
    s_off, m_off, t_off = run(ElasticClusterFrontend, port, Request, False)
    assert s_on == s_off
    assert 1 <= m_on <= 2 and m_off == 4 and t_on < t_off
    assert (s_on, m_on, t_on) == run(JaxElastic, ref, JaxRequest, True)


def _churn(elastic, replica, req_cls, fleet, **fe_kw):
    fe = elastic(lambda rid: replica(max_batch=2, max_seq=MAX_SEQ, rid=rid,
                                     chunk_len=CHUNK),
                 2, initial_replicas=2, seed=0, fleet_batch=fleet, **fe_kw)
    rng = np.random.default_rng(9)
    reqs = [req_cls(i, rng.integers(1, 400, int(rng.integers(3, 40))).tolist(),
                    max_new_tokens=6) for i in range(10)]
    for r in reqs:
        fe.submit(r)
    fe.tick(0.0)
    fe.fail_replica(0, 0)
    fe.tick(0.0)
    fe.scale_to(np.array([1, 1]))
    fe.tick(0.0)
    fe.scale_to(np.array([2, 2]))
    fe.run_until_drained()
    return _snap(reqs), fe


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "granite-3-8b"])
def test_fleet_chunked_parity_across_churn(arch):
    """Chunked admission inside a fleet survives failure, drain and
    scale-up (open cursors ride the slab rows through growth, removal and
    backfill) with streams and finish ticks identical to the per-replica
    path and to the reference's fleet (hybrid: carried ssm/conv state and
    offset KV writes)."""
    _, _, tm, tp = _pair(arch)
    port = lambda **kw: ReplicaEngine(tm, tp, device="cpu", **kw)
    fleet, fe = _churn(ElasticClusterFrontend, port, Request, True)
    assert fleet == _churn(ElasticClusterFrontend, port, Request, False)[0]
    assert fleet == _ref_churn(arch)[0]
    assert fe.ledger.balanced()


def _counts(fe):
    return (fe.decode_dispatches(), fe.prefill_dispatches(),
            fe.sync_count())


@functools.lru_cache(maxsize=None)
def _ref_churn(arch):
    jm, jp, _, _ = _shared(arch)
    snap, fe = _churn(JaxElastic, lambda **kw: JaxReplica(jm, jp, **kw),
                      JaxRequest, True)
    return snap, _counts(fe)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "granite-3-8b"])
def test_fleet_chunked_sharded_parity_across_churn(arch):
    """The churn above over a fleet mesh of 2 (hybrid) or 4 (dense)
    virtual shards: the open chunk cursors' rows move between shards on
    growth and backfill; streams, clocks and the dispatch and sync counts
    equal the reference's fleet run."""
    _, _, tm, tp = _shared(arch)
    shards = 2 if arch == "zamba2-2.7b" else 4
    got, fe = _churn(ElasticClusterFrontend,
                     lambda **kw: ReplicaEngine(tm, tp, device="cpu", **kw),
                     Request, True,
                     mesh=make_mesh((shards,), ("fleet",),
                                    devices=["cpu"] * shards))
    assert (got, _counts(fe)) == _ref_churn(arch)
    assert {g.shards for g in fe._fleets.values()} <= {shards}
    assert fe.ledger.balanced()


def test_chunk_len_dropped_for_non_f32_cache_as_in_the_reference():
    """Chunked admission needs an f32 cache: a bf16 or int8 cache keeps
    single-shot prefill (chunk_len 0), as the reference's engine does."""
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16), ("int8", "int8"),
                    (torch.float32, jnp.float32)):
        port = _port("granite-3-8b", max_batch=2, max_seq=MAX_SEQ,
                     chunk_len=CHUNK, cache_dtype=dt)
        ref = _ref("granite-3-8b", max_batch=2, max_seq=MAX_SEQ,
                   chunk_len=CHUNK, cache_dtype=jdt)
        assert port.chunk_len == ref.chunk_len == (
            CHUNK if dt is torch.float32 else 0)


def test_trace_accounting_counts_fleet_and_chunk_variants():
    """The port's count of distinct prefill shapes (bucketed, fleet and
    chunk dispatches) equals the reference's retrace count for the same
    run, and covers the async chunk dispatch."""
    jm, jp, tm, tp = _pair("granite-3-8b")

    def run(elastic, replica, req_cls):
        fe = elastic(lambda rid: replica(max_batch=2, max_seq=MAX_SEQ,
                                         rid=rid, chunk_len=CHUNK),
                     1, initial_replicas=2, seed=0)
        reqs = _reqs(req_cls, [6, 6, 20, 20], n_new=4, seed=7)
        for r in reqs:
            fe.submit(r)
        fe.run_until_drained()
        return fe, _snap(reqs)

    fe, snap = run(ElasticClusterFrontend,
                   lambda **kw: ReplicaEngine(tm, tp, device="cpu", **kw),
                   Request)
    jfe, jsnap = run(JaxElastic, lambda **kw: JaxReplica(jm, jp, **kw),
                     JaxRequest)
    assert snap == jsnap
    kinds = {s[0] for s in fe.replicas[0]._shapes}
    assert {"afleet_prefill", "afleet_chunk"} <= kinds
    assert fe.prefill_retraces() == jfe.prefill_retraces()


# ------------------------------------------------------ async + tier rules
def test_chunked_prefill_async_parity():
    """Chunked admission in async mode (cursor advance at dispatch,
    final-chunk commit at reconcile) equals the eager tick and the
    reference's async run."""
    jm, jp, tm, tp = _pair("granite-3-8b")

    def run(elastic, replica, req_cls, async_tick):
        rng = np.random.default_rng(2)
        fe = elastic(lambda rid: replica(max_batch=2, max_seq=MAX_SEQ,
                                         rid=rid, chunk_len=8),
                     1, initial_replicas=2, seed=0, async_tick=async_tick)
        reqs = [req_cls(i, rng.integers(1, 400, ln).tolist(),
                        max_new_tokens=4)
                for i, ln in enumerate([30, 5, 45, 6, 20, 7])]
        for r in reqs:
            fe.submit(r)
        fe.run_until_drained()
        return _snap(reqs)

    port = lambda **kw: ReplicaEngine(tm, tp, device="cpu", **kw)
    got = run(ElasticClusterFrontend, port, Request, True)
    assert got == run(ElasticClusterFrontend, port, Request, False)
    assert got == run(JaxElastic, lambda **kw: JaxReplica(jm, jp, **kw),
                      JaxRequest, True)


def _req(i, plen=4, n_new=3, tier=None):
    r = Request(i, [1 + (i + j) % 97 for j in range(plen)],
                max_new_tokens=n_new)
    if tier is not None:
        r.tier = tier
    return r


def test_low_tier_chunk_yields_last_free_slot():
    """A batch-tier chunk start must not take the last free slot while
    premium work waits."""
    eng = _port("granite-3-8b", max_batch=1, max_seq=MAX_SEQ,
                chunk_len=CHUNK, tiers=TIERS)
    long_batch = _req(0, plen=24, n_new=2, tier="batch")
    prem = _req(1, plen=4, n_new=2, tier="premium")
    eng.submit(long_batch)
    eng.submit(prem)
    # bank enough deficit that WDRR would hand the pop to the batch tier
    eng.queue._deficit[TIERS.index("batch")] = 1.5
    eng.queue._deficit[TIERS.index("premium")] = 0.0
    plans = eng.plan_admission()
    admitted = [r for _, reqs in plans.bucketed for r in reqs] + \
        [r for _, r in plans.singles] + \
        [cur.req for cur in eng._chunks.values()]
    assert prem in admitted
    assert long_batch not in admitted
    assert any(r is long_batch for r in eng.queue)


def test_chunk_throttle_under_premium_decode():
    """At most ONE below-decoding-tier chunk cursor advances a tick while a
    higher-tier slot decodes; without pressure all cursors advance."""
    eng = _port("granite-3-8b", max_batch=3, max_seq=MAX_SEQ,
                chunk_len=CHUNK, tiers=TIERS)
    eng.submit(_req(0, plen=4, n_new=20, tier="premium"))
    eng.submit(_req(1, plen=20, n_new=2, tier="batch"))
    eng.submit(_req(2, plen=20, n_new=2, tier="batch"))
    eng.step()
    assert len(eng._chunks) == 2 and eng.n_decoding == 1
    consumed = {s: cur.consumed for s, cur in eng._chunks.items()}
    eng.step()
    advanced = sum(1 for s, cur in eng._chunks.items()
                   if cur.consumed > consumed[s])
    assert advanced == 1
    eng2 = _port("granite-3-8b", max_batch=3, max_seq=MAX_SEQ,
                 chunk_len=CHUNK)
    for r in (_req(0, plen=4, n_new=20), _req(1, plen=20, n_new=2),
              _req(2, plen=20, n_new=2)):
        eng2.submit(r)
    eng2.step()
    before = {s: cur.consumed for s, cur in eng2._chunks.items()}
    eng2.step()
    assert all(cur.consumed > before[s]
               for s, cur in eng2._chunks.items() if s in before)


# ------------------------------------------------------------ control loop
def test_control_loop_chunk_len_matches_reference():
    """``--chunk-len 8 --max-seq 64`` in the control loop (async fleet,
    GPSO, the GCN+DDPG balancer): the digest over (rid, tier, output,
    arrival, first-token and finish ticks), the per-tick replica, dispatch
    and sync counts and the ledger equal the reference's."""
    jm, jp, tm, tp = _pair("granite-3-8b")
    args = serve.build_parser().parse_args(
        ["--device", "cpu", "--policy", "ours", "--autoscale", "gpso",
         "--ticks", "20", "--chunk-len", "8", "--max-seq", "64"])
    ref = cached_reference_loop(jm, jp, args)
    out = port_loop(tm, tp, args, ref)
    assert_loops_match(out, ref)
    assert any(s[0] == "afleet_chunk" for s in out["fe"].prefill_shapes())


def test_control_loop_chunk_len_sharded_matches_reference():
    """The loop above over 2 virtual shards (``--devices 2``) equals the
    reference's loop tick for tick."""
    jm, jp, tm, tp = _pair("granite-3-8b")
    args = serve.build_parser().parse_args(
        ["--device", "cpu", "--policy", "ours", "--autoscale", "gpso",
         "--ticks", "20", "--chunk-len", "8", "--max-seq", "64",
         "--devices", "2"])
    ref = cached_reference_loop(jm, jp, args)
    assert_loops_match(port_loop(tm, tp, args, ref), ref)
