"""The port's fused decode blocks (``--decode-block K``) and decode graphs
against the reference, in one process, on reduced configs.

Mirrors ``tests/test_async_serve.py``'s decode-block cases: K fused
micro-steps a dispatch are exact against single steps and against the
eager oracle, with fewer syncs and dispatches, and an admission waits at
most K - 1 ticks behind a block; streams, finish clocks and every count
equal the reference's for the same flags. The serve-level loop with
``--decode-block 4`` is held to the reference's for the dense and the ssm
family.

The decode graphs' own bookkeeping runs here without a card (capture
itself is ``chip_smoke.py``'s): a slab growth drops the group's graphs and
a remove does not, the masked dispatch reads fixed-size buffers and leaves
the other rows' state bit for bit, a standalone replica re-captures on a
pool handed back by its fleet, and a replay adds its graph's captured
launches to ``ops.LAUNCHES``. Streams and counts are exact throughout.
"""
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
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models.model import make_model
from repro_torch.serving.elastic import ElasticClusterFrontend
from repro_torch.serving.engine import FleetGroup, ReplicaEngine, Request
from repro_torch.serving.graphs import DecodeGraphs
from test_torch_control_loop import (assert_loops_match,
                                     cached_reference_loop, port_loop)
from test_torch_vlm import _one_torch_thread  # noqa: F401

MAX_SEQ = 64
TICKS = 15


def _pair(name):
    jm = jax_make_model(jax_get_config(name).reduced(), tp=1)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    tm = make_model(get_config(name).reduced(), tp=1)
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def models():
    return _pair("granite-3-8b")


def _reqs(cls, n, n_new=6, seed=3):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(1, 400, rng.integers(3, 9)).tolist(),
                max_new_tokens=n_new) for i in range(n)]


def _snap(reqs):
    return {r.rid: (tuple(r.output), r.finish_time, r.first_token_time)
            for r in reqs}


def _frontend(side, models, **kw):
    jm, jp, tm, tp = models
    if side == "jax":
        return JaxElastic(lambda rid: JaxReplica(jm, jp, max_batch=2,
                                                 max_seq=MAX_SEQ, rid=rid),
                          1, seed=0, **kw)
    return ElasticClusterFrontend(
        lambda rid: ReplicaEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ,
                                  rid=rid, device="cpu"), 1, seed=0, **kw)


# ------------------------------------------------------ the engine's blocks
def test_decode_block_exact_vs_single_steps(models):
    """decode_block=4 (one dispatch and one (K, cap, B) sync a block) is
    bit-exact against single-step async and the eager oracle, with fewer
    syncs and dispatches, and every count is the reference's."""
    def run(side, async_tick, block=1):
        fe = _frontend(side, models, initial_replicas=2,
                       async_tick=async_tick, decode_block=block)
        reqs = _reqs(JaxRequest if side == "jax" else Request, 4, n_new=12,
                     seed=5)                   # fills 2 x 2 slots, no queue
        for r in reqs:
            fe.submit(r)
        ticks = 0
        for _ in range(60):
            fe.tick(0.0)
            ticks += 1
            if not fe.pending and all(n.unfinished() == 0
                                      for n in fe.nodes):
                break
        return _snap(reqs), (fe.sync_count(), fe.decode_dispatches(),
                             ticks)

    got = {m: run("torch", *m) for m in ((False,), (True,), (True, 4))}
    want = {m: run("jax", *m) for m in ((False,), (True,), (True, 4))}
    assert got == want
    eager, single, block = (got[m] for m in ((False,), (True,), (True, 4)))
    assert eager[0] == single[0] == block[0]
    assert block[1][0] < single[1][0] < eager[1][0]     # syncs
    assert block[1][1] < single[1][1]                   # dispatches
    assert block[1][0] / block[1][2] < 1.0              # < 1 sync a tick


def test_decode_block_admission_lag_bounded(models):
    """Queued work behind a full slab re-admits at the block-end
    reconcile: the tokens are decode_block=1's, TTFT and finish lag by at
    most K - 1 ticks, and the block engaged (fewer syncs) -- the
    reference's trade, with its clocks."""
    K = 4

    def run(side, block):
        fe = _frontend(side, models, initial_replicas=1,
                       max_replicas_per_node=1, async_tick=True,
                       decode_block=block)
        reqs = _reqs(JaxRequest if side == "jax" else Request, 6, n_new=6,
                     seed=7)                   # 2 slots, 4 queued behind
        for r in reqs:
            fe.submit(r)
        fe.run_until_drained()
        return reqs, fe.sync_count()

    base, s1 = run("torch", 1)
    blocked, sk = run("torch", K)
    for rb, rk in zip(base, blocked):
        assert rb.output == rk.output
        assert 0 <= rk.first_token_time - rb.first_token_time <= K - 1
        assert 0 <= rk.finish_time - rb.finish_time <= K - 1
    assert sk < s1
    jblocked, jsk = run("jax", K)
    assert _snap(blocked) == _snap(jblocked) and sk == jsk


@pytest.mark.parametrize("arch", ["granite-3-8b", "mamba2-1.3b"])
def test_control_loop_decode_block_matches_reference(models, arch):
    """``--decode-block 4`` through ``run_control_loop``: streams, finish
    clocks, ledger, per-tick dispatches and syncs equal the reference's,
    and the blocks engaged: more micro-steps than dispatches, fewer syncs
    than the same loop at K = 1."""
    jm, jp, tm, tp = models if arch == "granite-3-8b" else _pair(arch)
    args = serve.build_parser().parse_args(
        ["--device", "cpu", "--policy", "ours", "--autoscale", "gpso",
         "--ticks", str(TICKS), "--decode-block", "4", "--arch", arch])
    ref = cached_reference_loop(jm, jp, args)
    out = port_loop(tm, tp, args, ref)
    assert_loops_match(out, ref)
    fe = out["fe"]
    assert fe.decode_steps() > fe.decode_dispatches()   # blocks of 4 ran
    args.decode_block = 1
    assert fe.sync_count() < port_loop(tm, tp, args, ref)["fe"].sync_count()


def test_control_loop_decode_block_sharded_matches_reference(models):
    """``--decode-block 4`` over 4 virtual shards equals the reference's
    loop of the test above: streams, clocks, ledger, per-tick dispatches
    and syncs; the blocks engaged on every shard."""
    jm, jp, tm, tp = models
    args = serve.build_parser().parse_args(
        ["--device", "cpu", "--policy", "ours", "--autoscale", "gpso",
         "--ticks", str(TICKS), "--decode-block", "4", "--arch",
         "granite-3-8b", "--devices", "4"])
    ref = cached_reference_loop(jm, jp, args)
    out = port_loop(tm, tp, args, ref)
    assert_loops_match(out, ref)
    fe = out["fe"]
    assert fe.decode_steps() > fe.decode_dispatches()
    assert fe.shard_dispatches()[1] > fe.decode_steps()


# ---------------------------------------------------- the graphs' bookkeeping
def _engines(models, n, max_batch=2):
    _, _, tm, tp = models
    return [ReplicaEngine(tm, tp, max_batch=max_batch, max_seq=MAX_SEQ,
                          rid=i, device="cpu") for i in range(n)]


def _admit_and_decode(g, engines, reqs):
    for e, r in zip(engines, reqs):
        e.submit(r)
    g.admit_round()
    g.decode_round()
    return g.reconcile()


def test_graphs_drop_on_slab_growth_not_on_remove(models):
    """A growth reallocates the slab and the operands: every graph goes and
    the next dispatch of a key captures again. A remove backfills in place:
    the graphs stay and the next dispatch replays."""
    _, _, tm, tp = models
    g = FleetGroup(tm, tp, max_batch=2, max_seq=MAX_SEQ, async_mode=True,
                   device="cpu")
    engines = _engines(models, 3)
    g.add(engines[0])
    reqs = _reqs(Request, 6, n_new=20)
    _admit_and_decode(g, engines[:1], reqs[:1])
    _admit_and_decode(g, engines[:1], [])
    assert g.graphs.stats() == {"captures": 1, "recaptures": 0,
                                "replays": 1}
    g.add(engines[1])                          # cap 1 -> 2: a new slab
    _admit_and_decode(g, engines[1:2], reqs[1:2])
    assert g.graphs.stats() == {"captures": 2, "recaptures": 1,
                                "replays": 1}
    g.add(engines[2])                          # cap 2 -> 4
    slab = {k: v.data_ptr() for k, v in g.slab.items()}
    ops_ptr = {k: v.data_ptr() for k, v in g.ops.items()}
    _admit_and_decode(g, engines[2:], reqs[2:3])
    g.remove(engines[0], restore=False)        # backfill: row 2 -> row 0
    assert {k: v.data_ptr() for k, v in g.slab.items()} == slab
    assert {k: v.data_ptr() for k, v in g.ops.items()} == ops_ptr
    _admit_and_decode(g, engines[1:], [])
    st = g.graphs.stats()
    assert (st["captures"], st["recaptures"]) == (3, 2)   # no capture
    assert st["replays"] == 2
    assert g.decode_steps == g.dispatches == 5


def test_masked_dispatch_reads_fixed_buffers_and_keeps_other_rows(models):
    """A sub-step round of some members: the stepping rows and the write
    index go into the fixed (cap,) and (cap * B,) buffers (the write index
    padded with the movers' own rows), the other members' slab rows and
    operands stay bit for bit, and the masked graph is its own key."""
    _, _, tm, tp = models
    g = FleetGroup(tm, tp, max_batch=2, max_seq=MAX_SEQ, async_mode=True,
                   device="cpu")
    engines = _engines(models, 3)
    for e in engines:
        g.add(e)
    _admit_and_decode(g, engines, _reqs(Request, 6, n_new=20))
    rows, write = g._masks["rows"], g._masks["write"]
    assert rows.shape == (g.cap,) and write.shape == (g.cap * 2,)
    before = {k: v.clone() for k, v in g.slab.items()}
    ops_before = {k: v.clone() for k, v in g.ops.items()}
    g.decode_round({id(engines[1])})           # only fleet row 1 steps
    g.reconcile()
    assert rows.data_ptr() == g._masks["rows"].data_ptr()
    assert rows.tolist() == [False, True, False, False]
    assert set(write.tolist()) == {2, 3}       # row 1's slots, repeated
    keep = [0, 1, 4, 5, 6, 7]
    for k, v in g.slab.items():
        assert torch.equal(v[:, keep], before[k][:, keep]), k
        assert not torch.equal(v[:, 2:4], before[k][:, 2:4]), k
    for k, v in g.ops.items():
        assert torch.equal(v[[0, 2, 3]], ops_before[k][[0, 2, 3]]), k
    assert (True, 1) in g.graphs._graphs and (False, 1) in g.graphs._graphs


def test_a_group_never_has_two_decodes_pending(models):
    """The outputs a replay returns are the graph's own buffers: a second
    decode dispatch before the reconcile would overwrite them, so it
    raises."""
    _, _, tm, tp = models
    g = FleetGroup(tm, tp, max_batch=2, max_seq=MAX_SEQ, async_mode=True,
                   device="cpu")
    e = _engines(models, 1)[0]
    g.add(e)
    e.submit(_reqs(Request, 1, n_new=20)[0])
    g.admit_round()
    g.decode_round()
    with pytest.raises(RuntimeError, match="still pending"):
        g.decode_round()


def test_standalone_graph_recaptures_on_a_handed_back_pool(models):
    """A replica's own decode graph reads its pool by address: joining a
    fleet drops it, and the pool handed back on remove is new, so the
    next standalone step captures again."""
    _, _, tm, tp = models
    g = FleetGroup(tm, tp, max_batch=2, max_seq=MAX_SEQ, device="cpu")
    e = _engines(models, 1)[0]
    for r in _reqs(Request, 2, n_new=30):
        e.submit(r)
    for _ in range(3):
        e.step()
    assert e.graphs.stats() == {"captures": 1, "recaptures": 0,
                                "replays": 2}
    g.add(e)
    g.decode_round()
    g.remove(e, restore=True)
    e.step()
    e.step()
    assert e.graphs.stats() == {"captures": 2, "recaptures": 1,
                                "replays": 3}


def test_eager_graphs_keep_no_bookkeeping():
    g = DecodeGraphs(torch.device("cpu"), eager=True)
    assert g.run("k", lambda: (torch.ones(1),))[0].item() == 1.0
    assert g.stats() == {"captures": 0, "recaptures": 0, "replays": 0}


class _RecordingGraphs(DecodeGraphs):
    """Graph semantics without a card: the capture runs ``fn`` once (the
    launches a capture records, counted by the wrappers) and a replay
    returns the captured outputs."""

    def __init__(self):
        super().__init__(torch.device("cpu"))
        self.capture = True

    def _warm(self, fn):
        return fn()

    def _capture(self, fn):
        outs = fn()
        return lambda: outs


def test_replays_add_the_captured_launches():
    """ops.LAUNCHES counts on the host: a capture's additions are taken
    back into the graph's count and each replay adds them, so the count is
    the launches that ran -- the warm-up dispatch's and each replay's."""
    saved = dict(ops.LAUNCHES)
    try:
        ops.reset_launches()
        g = _RecordingGraphs()

        def fn():
            ops.LAUNCHES["flash_decode"] += 40
            ops.LAUNCHES["ssd_scan"] += 2
            return (torch.zeros(3),)

        for _ in range(5):
            g.run(("full", 1), fn)
        assert ops.LAUNCHES["flash_decode"] == 5 * 40
        assert ops.LAUNCHES["ssd_scan"] == 5 * 2
        assert g.stats() == {"captures": 1, "recaptures": 0, "replays": 4}
        g.drop()
        g.run(("full", 1), fn)
        assert g.stats()["recaptures"] == 1
        assert ops.LAUNCHES["flash_decode"] == 6 * 40
    finally:
        ops.LAUNCHES.update(saved)


def test_capture_runs_with_the_collector_off(monkeypatch):
    """Python's cyclic collector is off while a graph is captured, and on
    again after (a failed capture too): a collection inside a capture
    that frees a dead owner's graphs invalidates the capture."""
    import contextlib
    import gc

    from repro_torch.serving import graphs

    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: None)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(graphs, "_capture_stream", lambda device: None)
    g = DecodeGraphs(torch.device("cpu"), eager=True)
    seen = []
    assert gc.isenabled()
    g._capture(lambda: seen.append(gc.isenabled()) or (torch.ones(1),))
    assert seen == [False] and gc.isenabled()

    def fails():
        raise RuntimeError("capture failed")
    with pytest.raises(RuntimeError, match="capture failed"):
        g._capture(fails)
    assert gc.isenabled()
