"""Fleets of vlm and audio replicas: the port against the reference's fleet
run, in one process.

Under its defaults (``fleet_batch=True``, ``async_tick=True``) the
reference's ``ElasticClusterFrontend`` puts every replica into a
``FleetGroup``, vlm and audio ones too: their exact-length single admits
carry the request's extras and ``write_slot`` copies the prefill's state
into the slab (a vlm row holds ``max_seq + num_patches`` positions, an
audio row fixed-``Le`` cross K/V). Reduced internvl2-2b and whisper-base,
the reference's weights bridged in, the same requests with numpy extras,
``max_batch`` 2, six requests and tests/test_fleet.py's churn (a failure
with work in flight, a graceful drain, a scale-up): the port's
``ElasticClusterFrontend`` (fleet, async) and ``ClusterFrontend(
fleet_batch=True)`` give the reference's fleet run's token streams, TTFT
and finish clocks, ledger terminals and dispatch/sync counts, on both of
the port's attention backends. A vlm/audio member leaves a fleet
mid-generation and its standalone engine continues the stream.

Two prompt lengths only: every exact length is one XLA compile on the
reference's side.
"""
import functools

import numpy as np
import pytest

from repro.serving import ClusterFrontend as JaxClusterFrontend
from repro.serving import ElasticClusterFrontend as JaxElastic
from repro.serving import ReplicaEngine as JaxReplica
from repro.serving import Request as JaxRequest
from repro_torch.launch.mesh import make_mesh
from repro_torch.serving.elastic import ElasticClusterFrontend
from repro_torch.serving.engine import (ClusterFrontend, FleetGroup,
                                        ReplicaEngine, Request)
from test_torch_vlm import _one_torch_thread  # noqa: F401
from test_torch_vlm import extras_of, pair

ARCHS = ("internvl2-2b", "whisper-base")
MAX_SEQ = 48
N_REQ = 6


def make_reqs(cls, cfg, n=N_REQ, seed=3):
    """``n`` requests of 3 or 6 tokens and 3-7 new tokens, each carrying
    its extra (patch or frame embeddings, numpy)."""
    rng = np.random.default_rng(seed)
    ex = extras_of(cfg, n, seed + 1)
    reqs = []
    for i in range(n):
        r = cls(i, rng.integers(1, 400, (3, 6)[i % 2]).tolist(),
                max_new_tokens=int(rng.integers(3, 8)))
        r.extras = ex[i]
        reqs.append(r)
    return reqs


def snap(reqs):
    return {r.rid: (tuple(r.output), r.first_token_time, r.finish_time)
            for r in reqs}


def factory(name, side, backend="einsum"):
    jm, jp, tm, tp = pair(name)
    if side == "jax":
        return lambda rid: JaxReplica(jm, jp, max_batch=2, max_seq=MAX_SEQ,
                                      rid=rid)
    return lambda rid: ReplicaEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ,
                                     rid=rid, attn_backend=backend,
                                     device="cpu")


def elastic_churn(name, side, backend="einsum", **fe_kw):
    """tests/test_fleet.py's churn script through the elastic frontend
    (fleet, async): streams and clocks, the ledger's terminals and the
    dispatch/sync counts."""
    cls = JaxElastic if side == "jax" else ElasticClusterFrontend
    fe = cls(factory(name, side, backend), 2, initial_replicas=2, seed=0,
             **fe_kw)
    reqs = make_reqs(JaxRequest if side == "jax" else Request,
                     pair(name)[2].cfg)
    for r in reqs:
        fe.submit(r)
    fe.tick(0.0)
    fe.fail_replica(0, 0)
    fe.tick(0.0)
    fe.scale_to(np.array([1, 1]))
    fe.tick(0.0)
    fe.scale_to(np.array([2, 2]))
    fe.run_until_drained()
    assert fe.ledger.balanced()
    return (snap(reqs), fe.ledger.balance(),
            (fe.decode_dispatches(), fe.prefill_dispatches(),
             fe.sync_count(), fe.replicas_spawned, fe.failed_replicas))


def cluster_run(name, side, backend="einsum"):
    """Three replicas behind the static frontend with fleet batching:
    streams, clocks and the groups' decode dispatches."""
    mk = factory(name, side, backend)
    fe = (JaxClusterFrontend if side == "jax" else ClusterFrontend)(
        [mk(i) for i in range(3)], policy="lc", seed=0, fleet_batch=True)
    reqs = make_reqs(JaxRequest if side == "jax" else Request,
                     pair(name)[2].cfg, seed=5)
    for r in reqs:
        fe.submit(r)
    fe.run_until_drained()
    return snap(reqs), sum(g.dispatches for g in fe.fleets.values())


@functools.lru_cache(maxsize=None)
def reference(name, kind):
    return (elastic_churn if kind == "elastic" else cluster_run)(name, "jax")


# (name, backend, shards): both backends unsharded, the kernel backend
# over 2 virtual CPU shards too
ELASTIC_CASES = [pytest.param(n, b, 1, id=f"{n}-{b}")
                 for b in ("pallas", "einsum") for n in ARCHS] + [
    pytest.param(n, "pallas", 2, id=f"{n}-pallas-2shards") for n in ARCHS]


@pytest.mark.parametrize("name,backend,shards", ELASTIC_CASES)
def test_elastic_fleet_matches_reference(name, backend, shards):
    """``shards`` > 1 splits the group's slab rows (the vlm prefix rows,
    audio's fixed-Le cross K/V) over a mesh of virtual CPU shards: each
    exact-length admit with extras writes into the shard that owns its
    rows, and the run equals the same reference run (the reference's
    sharded run equals its unsharded one)."""
    mesh = None if shards == 1 else make_mesh(
        (shards,), ("fleet",), devices=["cpu"] * shards)
    got = elastic_churn(name, "torch", backend, mesh=mesh)
    assert got == reference(name, "elastic")
    assert got[2][0] > 0                  # the fleet decoded
    assert all(len(out) > 1 for out, _, _ in got[0].values())


@pytest.mark.parametrize("backend", ["pallas", "einsum"])
@pytest.mark.parametrize("name", ARCHS)
def test_cluster_frontend_fleet_matches_reference(name, backend):
    got = cluster_run(name, "torch", backend)
    assert got == reference(name, "cluster")
    assert got[1] > 0


@pytest.mark.parametrize("name", ARCHS)
def test_member_leaves_mid_generation(name):
    """A member with in-flight requests joins a fleet, decodes there, and
    leaves with its rows handed back (``remove(restore=True)``); its
    standalone engine continues the streams as one that never joined."""
    _, _, tm, tp = pair(name)
    mk = lambda: ReplicaEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ,
                               device="cpu")
    oracle, eng, other = mk(), mk(), mk()
    want, got = make_reqs(Request, tm.cfg, 2), make_reqs(Request, tm.cfg, 2)
    for a, b in zip(want, got):
        a.max_new_tokens = b.max_new_tokens = 9
        oracle.submit(a)
        eng.submit(b)
    for _ in range(2):
        oracle.step()
        eng.step()
    g = FleetGroup(tm, tp, max_batch=2, max_seq=MAX_SEQ, async_mode=True,
                   device="cpu")
    g.add(other)
    g.add(eng)
    for _ in range(3):
        oracle.step()
        eng.begin_step(admit=False)
        g.admit_round()
        g.decode_round()
        g.reconcile()
    g.remove(eng, restore=True)
    assert eng._fleet is None and set(eng.cache) == set(g.slab)
    for _ in range(20):
        oracle.step()
        eng.step()
    assert snap(got) == snap(want)
    assert all(len(r.output) == 9 for r in got)
