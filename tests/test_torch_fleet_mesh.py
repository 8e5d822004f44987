"""Fleet-mesh serving of the port: the layout of a ``FleetGroup`` whose
slab rows split over the shards of a ``('fleet',)`` mesh, the mesh
builders, the sharding rules and the sequence-sharded decode.

The sharded runs are held to the reference where its runs are made:
tests/test_torch_elastic.py (the churn matrix, every fleet mode, the pad
row), test_torch_chunked_prefill.py (chunked churn, hybrid and dense),
test_torch_ssm_serve.py (the ssm and hybrid loops),
test_torch_decode_block.py, test_torch_clients.py (tiers),
test_torch_cells.py, test_torch_control_loop.py (``--devices`` /
``--mesh``) and test_torch_fleet_extras.py (vlm and audio). Here, over
virtual CPU shards
(``launch.mesh.set_host_device_count``): one logical decode dispatch and
at most one sync a tick; caps 4, 4, 8, 8 at 3, 4, 5, 8 members under 4
shards (tests/test_fleet_shard.py), rows moving shard on growth with their
contents; ``remove(restore=True)`` across shards; the builders, and no
mapping of n shards onto fewer cards. The rules (``distributed.sharding``)
are held per leaf to the reference's plain functions, and
``seq_sharded_flash_decode`` to the reference's oracle on a (2, 4) mesh.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.distributed import seq_kv as jax_seq_kv
from repro.distributed import sharding as jax_sharding
from repro.kernels.ref import decode_attention_ref
from repro_torch.configs import get_config
from repro_torch.distributed import seq_kv, sharding
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.mesh import (Mesh, make_fleet_mesh, make_host_mesh,
                                     make_mesh, parse_mesh_spec,
                                     set_host_device_count)
from repro_torch.models.model import make_model
from repro_torch.serving.elastic import ElasticClusterFrontend
from repro_torch.serving.engine import (ClusterFrontend, FleetGroup,
                                        ReplicaEngine, Request)
from test_torch_vlm import _one_torch_thread  # noqa: F401

MAX_SEQ = 64


@pytest.fixture(scope="module", autouse=True)
def _eight_host_devices():
    with meshlib.host_device_count(8):
        yield


@functools.lru_cache(maxsize=None)
def model_for(arch):
    m = make_model(get_config(arch).reduced(), tp=1)
    return m, m.init(seed=0, dtype=torch.float32, device="cpu")


def mesh_of(shards):
    return None if shards == 1 else make_fleet_mesh(shards, device="cpu")


def make_reqs(n, n_new=6, seed=3):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(1, 400, rng.integers(3, 9)).tolist(),
                    max_new_tokens=n_new) for i in range(n)]


def test_one_dispatch_one_sync_per_tick_sharded():
    """One logical decode dispatch per group per tick, at most one sync,
    on a saturated slab over 4 shards; each shard's dispatch launched."""
    m, p = model_for("granite-3-8b")
    fe = ElasticClusterFrontend(
        lambda rid: ReplicaEngine(m, p, max_batch=2, max_seq=MAX_SEQ,
                                  rid=rid, device="cpu"),
        2, initial_replicas=2, seed=0, mesh=mesh_of(4))
    for r in make_reqs(16, n_new=8):
        fe.submit(r)
    for i in range(4):
        mtr = fe.tick(0.0)
        assert mtr["fleet_groups"] == 1 and mtr["syncs"] <= 1
        if i > 0:
            assert mtr["decode_dispatches"] == 1
    (g,) = fe._fleets.values()
    assert g.shards == 4 and g.cap == 4
    assert g.graph_stats()["captures"] == 4    # one key, once a shard
    fe.run_until_drained()


def test_growth_keeps_fleet_rows_divisible():
    """3 -> 4 -> 5 -> 8 members under 4 shards allocates caps 4, 4, 8, 8
    (tests/test_fleet_shard.py:247); each shard holds cap / 4 rows on its
    device, placed by ``fleet_slab_shardings``; a member's rows move to
    another shard on growth and keep their contents."""
    m, p = model_for("granite-3-8b")
    mesh = mesh_of(4)
    g = FleetGroup(m, p, max_batch=2, max_seq=MAX_SEQ, mesh=mesh,
                   async_mode=True, device="cpu")
    engs = [ReplicaEngine(m, p, max_batch=2, max_seq=MAX_SEQ, rid=i,
                          device="cpu") for i in range(8)]
    for i, e in enumerate(engs):
        for c in e.cache.values():
            c.fill_(float(i + 1))
    caps = []
    for i, e in enumerate(engs):
        g.add(e)
        if i + 1 in (3, 4, 5, 8):
            caps.append([i + 1, g.cap])
    assert caps == [[3, 4], [4, 4], [5, 8], [8, 8]]
    for d, part in enumerate(g.parts):
        assert (part.lo, part.rows) == (2 * d, 2)
        for name, s in part.slab.items():
            assert s.shape[1] == 2 * 2
            assert sharding.fleet_slab_shardings(
                mesh, {name: (s.shape[0], 16) + tuple(s.shape[2:])}
            )[name][1] == "fleet"
    for f in range(8):                        # row f holds member f's state
        part, i = g._where(f)
        assert float(part.slab["k"][0, 2 * i, 0, 0, 0]) == f + 1
    with pytest.raises(AttributeError, match="per shard"):
        g.slab


def test_restore_hands_back_a_cache_on_the_engines_device():
    """``remove(restore=True)`` from a shard other than the first gives
    the engine its rows, whole, as a plain cache it can decode from."""
    m, p = model_for("granite-3-8b")
    g = FleetGroup(m, p, max_batch=2, max_seq=MAX_SEQ, mesh=mesh_of(2),
                   device="cpu")
    engs = [ReplicaEngine(m, p, max_batch=2, max_seq=MAX_SEQ, device="cpu")
            for _ in range(3)]
    for i, e in enumerate(engs):
        e.cache["k"].fill_(float(i + 1))
        g.add(e)
    assert g._where(2)[0] is g.parts[1]
    g.remove(engs[0], restore=False)           # row 2 backfills row 0
    assert engs[2]._fleet_row == 0
    g.remove(engs[2], restore=True)
    k = engs[2].cache["k"]
    assert k.shape[1] == 2 and k.is_contiguous() and bool((k == 3).all())


# ---------------------------------------------------------------- meshes
def test_mesh_builders_and_spec():
    mesh = make_fleet_mesh(4, device="cpu")
    assert mesh.shape == {"fleet": 4} and mesh.size == 4
    assert mesh.axis_devices("fleet") == [torch.device("cpu")] * 4
    m2 = parse_mesh_spec("2x4:data,model", device="cpu")
    assert m2.axis_names == ("data", "model") and m2.shape == \
        {"data": 2, "model": 4}
    assert make_host_mesh(2, 4).shape == m2.shape
    with pytest.raises(RuntimeError, match="needs 16 cpu"):
        make_fleet_mesh(16, device="cpu")
    with pytest.raises(ValueError, match="'fleet' axis"):
        FleetGroup(*model_for("granite-3-8b"), max_batch=2, max_seq=8,
                   mesh=m2, device="cpu")
    # a (fleet 2, model 2) group serves: each replica's cache split by
    # kv heads over 'model' (tests/test_torch_fleet_model_axis.py holds it
    # to the reference)
    m, p = model_for("granite-3-8b")
    fe = ClusterFrontend(
        [ReplicaEngine(m, p, max_batch=2, max_seq=8, rid=i, device="cpu")
         for i in range(2)], policy="rr", fleet_batch=True,
        mesh=parse_mesh_spec("2x2:fleet,model", device="cpu"))
    reqs = make_reqs(3, n_new=3)
    for r in reqs:
        fe.submit(r)
    fe.run_until_drained()
    assert all(r.done and r.output for r in reqs)
    (g,) = fe.fleets.values()
    assert (g.shards, g.heads) == (2, 2)


def test_cuda_mesh_never_maps_onto_fewer_cards(monkeypatch):
    """n shards need n cards; only an explicit list repeats a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert make_fleet_mesh(1).axis_devices("fleet") == \
        [torch.device("cuda", 0)]
    with pytest.raises(RuntimeError, match="needs 2 cuda device"):
        make_fleet_mesh(2)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="needs 2 cuda device"):
        serve.main(["--device", "cuda", "--policy", "ours", "--devices",
                    "2"])
    twice = make_mesh((2,), ("fleet",), devices=["cuda:0", "cuda:0"])
    assert twice.axis_devices("fleet") == [torch.device("cuda", 0)] * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        make_fleet_mesh(1)


# ----------------------------------------------------------------- rules
LEAVES = {"k": (2, 8, 16, 4, 8), "attn_v": (1, 8, 16, 4, 8),
          "self_k": (2, 8, 16, 4, 8), "cross_v": (2, 8, 12, 4, 8),
          "ssm": (2, 8, 4, 8, 16), "conv": (2, 8, 3, 12),
          "k_s": (2, 8, 16, 4)}
MESHES = {"fleet": ((4,), ("fleet",)),
          "fleet-model": ((2, 2), ("fleet", "model")),
          "fleet-data-model": ((2, 2, 2), ("fleet", "data", "model")),
          "data-model": ((2, 4), ("data", "model"))}


def _port_mesh(name):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, device="cpu")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_serve_state_rules_match_reference(mesh_name):
    """Per leaf of one replica's state, ``_serve_state_entries`` and
    ``_fits`` equal the reference's (plain functions, given the port's
    mesh), entry by entry and dim by dim."""
    mesh = _port_mesh(mesh_name)
    dp = tuple(a for a in ("pod", "data", "expert")
               if a in mesh.axis_names) or None
    tp = "model" if "model" in mesh.axis_names else None
    for name, shape in LEAVES.items():
        entries = sharding._serve_state_entries(name, len(shape), dp, tp)
        assert entries == jax_sharding._serve_state_entries(
            name, len(shape), dp, tp), name
        for e, d in zip(entries, shape):
            assert sharding._fits(e, d, mesh) == \
                jax_sharding._fits(e, d, mesh), (name, e, d)


@pytest.mark.parametrize("mesh_name", ["fleet", "fleet-model",
                                       "fleet-data-model"])
def test_fleet_slab_rules_match_reference(mesh_name):
    """The flat slab's entries are the reference's stacked ones
    ``(fleet, L, B, ...)`` folded: the rows dim carries the fleet and
    batch entries, the rest as they are."""
    mesh = _port_mesh(mesh_name)
    cap = 4
    dp = tuple(a for a in ("pod", "data", "expert")
               if a in mesh.axis_names) or None
    tp = "model" if "model" in mesh.axis_names else None
    flat = {n: (s[0], cap * s[1]) + s[2:] for n, s in LEAVES.items()}
    got = sharding.fleet_slab_shardings(mesh, flat)
    for name, shape in LEAVES.items():
        ref = ("fleet",) + jax_sharding._serve_state_entries(
            name, len(shape), dp, tp)
        rows = ("fleet",) + (jax_sharding._serve_state_entries(
            name, len(shape), dp, tp)[1] or ())
        want = (ref[1], rows if len(rows) > 1 else "fleet") + ref[3:]
        want = tuple(e if jax_sharding._fits(e, d, mesh) else None
                     for e, d in zip(want, flat[name]))
        assert got[name] == want, name
    with pytest.raises(ValueError, match="'fleet' axis"):
        sharding.fleet_slab_shardings(_port_mesh("data-model"), flat)


# ---------------------------------------------------------------- seq_kv
CASES = [(2, 8, 2, 256, 32, 100), (2, 4, 4, 512, 64, 0),
         (4, 8, 1, 256, 32, 255)]        # tests/test_seq_kv.py's


@functools.lru_cache(maxsize=None)
def _jitted_refs():
    return (jax.jit(decode_attention_ref, static_argnums=3),
            jax.jit(jax_seq_kv._local_partial, static_argnums=(3, 4)))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"S{c[3]}-pos{c[5]}")
def test_seq_sharded_decode_matches_reference_oracle(case):
    """tests/test_seq_kv.py's three cases on a (data 2, model 4) mesh of
    virtual shards, inputs from a numpy seed: within 1e-4 of the
    reference's oracle; one shard's partial against the reference's."""
    B, Hq, KV, S, d, pos = case
    rng = np.random.default_rng(S + pos)
    q, kc, vc = (rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Hq, d), (B, S, KV, d), (B, S, KV, d)))
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    out = seq_kv.seq_sharded_flash_decode(
        mesh, torch.from_numpy(q), torch.from_numpy(kc),
        torch.from_numpy(vc), pos)
    oracle, partial = _jitted_refs()
    want = oracle(q, kc.transpose(0, 2, 1, 3), vc.transpose(0, 2, 1, 3),
                  pos)
    assert float(np.max(np.abs(out.numpy() - np.asarray(want)))) < 1e-4
    k, v = kc[:, 64:128], vc[:, 64:128]
    for got, ref in zip(seq_kv._local_partial(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            pos, 64), partial(q, k, v, pos, 64)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


def test_seq_kv_cache_bytes_match_reference():
    for arch in ("granite-3-8b", "mistral-nemo-12b", "whisper-base"):
        from repro.configs import get_config as jax_get_config
        assert seq_kv.seq_kv_cache_bytes(get_config(arch), 4, 4096) == \
            jax_seq_kv.seq_kv_cache_bytes(jax_get_config(arch), 4, 4096)


def test_set_host_device_count_refuses_zero():
    with pytest.raises(ValueError):
        set_host_device_count(0)
    assert meshlib._host_devices == 8
    assert isinstance(mesh_of(2), Mesh)
