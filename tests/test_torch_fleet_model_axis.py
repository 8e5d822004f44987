"""Fleet groups over ``model`` and data-like mesh axes: each replica's
serve state split by heads over ``model`` (``sharding.HeadLayout``,
``layers.HeadBlocks``) and its group's rows over ``fleet`` x the data-like
axes, held to the reference's runs on the same meshes.

The reference needs ``--xla_force_host_platform_device_count`` before jax
starts, so all of its runs go in ONE subprocess (as
tests/test_fleet_shard.py runs its own), which prints a JSON summary:
tests/test_fleet.py's churn script (a failure with work in flight, a
graceful drain, a scale-up, then drain to empty) through its
``ElasticClusterFrontend(mesh=...)`` for each (arch, mesh) case, and the
head range of every slab leaf on every device of the mesh
(``devices_indices_map``). The port runs the same script in this process
on virtual CPU devices (``launch.mesh.host_device_count``), the
reference's weights bridged in, torch on one thread. Against the
reference's run on the same mesh: token streams, TTFT and finish clocks,
the decode / prefill / sync counts in total and per tick, and the
ledger's terminals. Against its layout: each device's head block of each
leaf, the whole leaf where the ``model`` axis does not divide it
(reduced granite's 2 kv heads on ``model`` 4). Meshes (fleet 2, model
2), (fleet 2, data 2), (fleet 1, data 2, model 2), (fleet 1, model 4);
every family of the port on the first (whisper-base's self and cross
caches, grok-1-314b's MoE), granite and mamba2 on the others (mamba2's 8
SSM heads split four ways on the last), and grok-1-314b on (fleet 2,
data 2): its routing is per batch row, so splitting the rows over
``data`` changes no value; granite with the int8 cache (``:int8``) on
(fleet 2, model 2), whose four leaves no rule names: whole on each
device, as the reference replicates them; granite on (fleet 2, seq 2) and
mamba2 on (fleet 1, seq 2, model 2): ``seq`` names no part of the slab,
which the reference replicates over it, so each row block runs on index
0 of it. The CLI case runs
``--mesh 2x2:fleet,model`` through test_torch_control_loop's
``port_loop``, held to the reference's loop of the same flags (its
sharded loop equals its unsharded one).
"""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.distributed.sharding import _head_dim
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.mesh import make_mesh, parse_mesh_spec
from repro_torch.models.layers import HeadBlocks
from repro_torch.serving.elastic import ElasticClusterFrontend
from repro_torch.serving.engine import FleetGroup, ReplicaEngine, Request
from test_torch_vlm import _one_torch_thread  # noqa: F401
from test_torch_vlm import extras_of, pair

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {"fleet-model": ((2, 2), ("fleet", "model")),
          "fleet-data": ((2, 2), ("fleet", "data")),
          "fleet-data-model": ((1, 2, 2), ("fleet", "data", "model")),
          "fleet-model4": ((1, 4), ("fleet", "model")),
          "fleet-seq": ((2, 2), ("fleet", "seq")),
          "fleet-seq-model": ((1, 2, 2), ("fleet", "seq", "model"))}
CASES = [(a, "fleet-model") for a in ("granite-3-8b", "mamba2-1.3b",
                                      "zamba2-2.7b", "whisper-base",
                                      "grok-1-314b")] + [
    (a, m) for m in ("fleet-data", "fleet-data-model", "fleet-model4")
    for a in ("granite-3-8b", "mamba2-1.3b")] + [
    ("grok-1-314b", "fleet-data"), ("granite-3-8b:int8", "fleet-model"),
    ("granite-3-8b", "fleet-seq"), ("mamba2-1.3b", "fleet-seq-model")]
MAX_SEQ = {"whisper-base": 48}          # the others 64


_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs import get_config
from repro.launch.mesh import make_mesh
from repro.models import make_model
from repro.serving import ElasticClusterFrontend, FleetGroup, ReplicaEngine
from repro.serving import Request

meshes, cases, max_seq = json.loads(sys.argv[1])


def extras_of(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [{"frame_embeds": (0.1 * rng.standard_normal(
        (1, cfg.encoder_seq_len, cfg.d_model))).astype(np.float32)}
        for _ in range(n)]


def make_reqs(arch, cfg):
    rng = np.random.default_rng(3)
    if arch != "whisper-base":
        return [Request(i, rng.integers(1, 400, rng.integers(3, 9)).tolist(),
                        max_new_tokens=6) for i in range(10)]
    ex = extras_of(cfg, 6, 4)
    reqs = []
    for i in range(6):
        r = Request(i, rng.integers(1, 400, (3, 6)[i % 2]).tolist(),
                    max_new_tokens=int(rng.integers(3, 8)))
        r.extras = ex[i]
        reqs.append(r)
    return reqs


models = {}
def model_for(arch):
    if arch not in models:
        m = make_model(get_config(arch).reduced(), tp=1)
        models[arch] = (m, jax.jit(m.init, static_argnums=1)(
            jax.random.PRNGKey(0), jnp.float32))
    return models[arch]


def layout(g, mesh):
    out = {}
    for name, leaf in g.slab.items():
        idx = leaf.sharding.devices_indices_map(leaf.shape)
        rows = []
        for coords in np.ndindex(mesh.devices.shape):
            sl = idx[mesh.devices[coords]]
            rows.append([list(map(int, coords)),
                         [[s.start or 0, leaf.shape[d] if s.stop is None
                           else s.stop] for d, s in enumerate(sl)]])
        out[name] = rows
    return out


out = {}
for case, mname in cases:
    arch, _, dtype = case.partition(":")
    kw = {"cache_dtype": dtype} if dtype else {}
    shape, axes = meshes[mname]
    mesh = make_mesh(shape, axes)
    m, params = model_for(arch)
    S = max_seq.get(arch, 64)
    fe = ElasticClusterFrontend(
        lambda rid: ReplicaEngine(m, params, max_batch=2, max_seq=S,
                                  rid=rid, **kw), 2, initial_replicas=2,
        seed=0, mesh=mesh)
    reqs = make_reqs(arch, m.cfg)
    for r in reqs:
        fe.submit(r)
    ticks = [fe.tick(0.0)]
    fe.fail_replica(0, 0)
    ticks.append(fe.tick(0.0))
    fe.scale_to(np.array([1, 1]))
    ticks.append(fe.tick(0.0))
    fe.scale_to(np.array([2, 2]))
    fe.run_until_drained()
    g = FleetGroup(m, params, max_batch=2, max_seq=S, mesh=mesh, **kw)
    for i in range(shape[0]):
        g.add(ReplicaEngine(m, params, max_batch=2, max_seq=S, rid=i, **kw))
    out[case + "|" + mname] = {
        "streams": {str(r.rid): [[int(t) for t in r.output],
                                 r.first_token_time, r.finish_time]
                    for r in reqs},
        "counts": [fe.decode_dispatches(), fe.prefill_dispatches(),
                   fe.sync_count(), fe.replicas_spawned,
                   fe.failed_replicas],
        "ticks": [[int(t["decode_dispatches"]), int(t["prefill_dispatches"]),
                   int(t["syncs"]), [int(x) for x in t["active_replicas"]]]
                  for t in ticks],
        "ledger": fe.ledger.balance(),
        "layout": layout(g, mesh)}
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def _four_host_devices():
    with meshlib.host_device_count(4):
        yield


@pytest.fixture(scope="module")
def reference():
    """Every reference run of the file, in one subprocess."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    arg = json.dumps([MESHES, CASES, MAX_SEQ])
    res = subprocess.run([sys.executable, "-c", _SCRIPT, arg],
                         capture_output=True, text=True, env=env,
                         timeout=900)
    lines = [ln for ln in res.stdout.splitlines()
             if ln.startswith("RESULT ")]
    assert lines, res.stderr[-4000:]
    return json.loads(lines[-1][len("RESULT "):])


def _mesh(name):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, device="cpu")


def _reqs(arch, cfg):
    rng = np.random.default_rng(3)
    if arch != "whisper-base":
        return [Request(i, rng.integers(1, 400, rng.integers(3, 9)).tolist(),
                        max_new_tokens=6) for i in range(10)]
    ex = extras_of(cfg, 6, 4)
    reqs = []
    for i in range(6):
        r = Request(i, rng.integers(1, 400, (3, 6)[i % 2]).tolist(),
                    max_new_tokens=int(rng.integers(3, 8)))
        r.extras = ex[i]
        reqs.append(r)
    return reqs


@functools.lru_cache(maxsize=None)
def _port(arch):
    return pair(arch)[2:]


def port_churn(case, mesh):
    arch, _, dtype = case.partition(":")
    kw = {"cache_dtype": dtype} if dtype else {}
    tm, tp = _port(arch)
    S = MAX_SEQ.get(arch, 64)
    fe = ElasticClusterFrontend(
        lambda rid: ReplicaEngine(tm, tp, max_batch=2, max_seq=S, rid=rid,
                                  device="cpu", **kw),
        2, initial_replicas=2, seed=0, mesh=mesh)
    reqs = _reqs(arch, tm.cfg)
    for r in reqs:
        fe.submit(r)
    ticks = [fe.tick(0.0)]
    fe.fail_replica(0, 0)
    ticks.append(fe.tick(0.0))
    fe.scale_to(np.array([1, 1]))
    ticks.append(fe.tick(0.0))
    fe.scale_to(np.array([2, 2]))
    fe.run_until_drained()
    return {
        "streams": {str(r.rid): [[int(t) for t in r.output],
                                 r.first_token_time, r.finish_time]
                    for r in reqs},
        "counts": [fe.decode_dispatches(), fe.prefill_dispatches(),
                   fe.sync_count(), fe.replicas_spawned,
                   fe.failed_replicas],
        "ticks": [[int(t["decode_dispatches"]), int(t["prefill_dispatches"]),
                   int(t["syncs"]), [int(x) for x in t["active_replicas"]]]
                  for t in ticks],
        "ledger": fe.ledger.balance()}, fe


@pytest.mark.parametrize("case,mesh_name", CASES,
                         ids=[f"{a}-{m}" for a, m in CASES])
def test_churn_matches_reference_on_the_same_mesh(reference, case,
                                                  mesh_name):
    """Streams, clocks, total and per-tick counts and the ledger's
    terminals equal the reference's run on the same mesh; the group's
    state is split over the mesh's ``model`` devices (HeadBlocks) and
    every shard decoded."""
    got, fe = port_churn(case, _mesh(mesh_name))
    want = json.loads(json.dumps(reference[f"{case}|{mesh_name}"]))
    got = json.loads(json.dumps(got))
    for key in ("streams", "counts", "ticks", "ledger"):
        assert got[key] == want[key], key
    assert fe.ledger.balanced()
    (g,) = fe._fleets.values()
    shape = dict(zip(MESHES[mesh_name][1], MESHES[mesh_name][0]))
    assert g.heads == shape.get("model", 1)
    assert g.shards == shape["fleet"] * shape.get("data", 1)
    leaves = list(g.parts[0].slab.values())
    assert all(isinstance(t, HeadBlocks) for t in leaves) == (g.heads > 1)
    assert fe.shard_dispatches()[1] >= fe.decode_steps() > 0


def _row_coords(mesh_name, r, m):
    """Mesh coordinates of row block ``r``'s ``model`` device ``m``."""
    shape, axes = MESHES[mesh_name]
    rows = [a for a in ("fleet", "pod", "data", "expert") if a in axes]
    idx = dict(zip(rows, np.unravel_index(r, [shape[axes.index(a)]
                                               for a in rows])))
    idx["model"] = m
    return [int(idx.get(a, 0)) for a in axes]


@pytest.mark.parametrize("case,mesh_name", CASES,
                         ids=[f"{a}-{m}" for a, m in CASES])
def test_head_blocks_are_the_references(reference, case, mesh_name):
    """Each device's range of each leaf's head dim (kv heads, SSM heads,
    conv channels; the whole dim where ``model`` does not divide it, and
    for the int8 leaves no rule names) is the reference's
    ``devices_indices_map`` range on the device of the same mesh
    coordinates. Rows are laid out per member (the port's slab is flat:
    a row block holds whole members), heads as the reference."""
    arch, _, dtype = case.partition(":")
    kw = {"cache_dtype": dtype} if dtype else {}
    tm, tp = _port(arch)
    S = MAX_SEQ.get(arch, 64)
    shape, _ = MESHES[mesh_name]
    g = FleetGroup(tm, tp, max_batch=2, max_seq=S, mesh=_mesh(mesh_name),
                   device="cpu", **kw)
    for i in range(shape[0]):
        g.add(ReplicaEngine(tm, tp, max_batch=2, max_seq=S, rid=i,
                            device="cpu", **kw))
    want = reference[f"{case}|{mesh_name}"]["layout"]
    assert set(want) == set(g.parts[0].slab)
    for name, rows in want.items():
        by_coords = {tuple(c): ranges for c, ranges in rows}
        for r, part in enumerate(g.parts):
            leaf = part.slab[name]
            if isinstance(leaf, HeadBlocks):
                dim, blocks = leaf.dim, leaf.bounds
            else:                         # no model axis: whole
                dim = _head_dim(name, leaf.ndim)
                blocks = [(0, leaf.shape[dim])]
            for m, (lo, hi) in enumerate(blocks):
                ranges = by_coords[tuple(_row_coords(mesh_name, r, m))]
                # the reference's leaf is (cap, L, B, ...): dim + 1
                assert [lo, hi] == ranges[dim + 1], (name, r, m)


def test_whole_leaf_where_model_does_not_divide():
    """Reduced granite has 2 kv heads: on ``model`` 4 its caches are
    whole on each of the four devices (the rule, not a caught error); on
    ``model`` 2 each device holds one head. Its prefill's flash_attention
    plain version and the decode's run once a device either way."""
    tm, tp = _port("granite-3-8b")
    for mesh_name, want in (("fleet-model4", [(0, 2)] * 4),
                            ("fleet-model", [(0, 1), (1, 2)])):
        g = FleetGroup(tm, tp, max_batch=2, max_seq=64,
                       mesh=_mesh(mesh_name), device="cpu")
        g.add(ReplicaEngine(tm, tp, max_batch=2, max_seq=64, device="cpu"))
        k = g.parts[0].slab["k"]
        assert isinstance(k, HeadBlocks) and k.bounds == want
        assert k.dim == 3 and [p.shape[3] for p in k.parts] == \
            [hi - lo for lo, hi in want]


def test_head_blocks_index_write_and_gather():
    """HeadBlocks' views, writes and gathers address the same elements as
    the whole tensor would."""
    full = torch.arange(2 * 3 * 4 * 6, dtype=torch.float32).reshape(
        2, 3, 4, 6)
    hb = HeadBlocks([full[:, :, :, :3].clone(), full[:, :, :, 3:].clone()],
                    3, [(0, 3), (3, 6)])
    assert hb.shape == full.shape and not hb.whole
    idx = torch.tensor([2, 0])
    assert torch.equal(hb[1][:, idx].gather(), full[1][:, idx])
    val = torch.randn(2, 2, 4, 6)
    hb[:, idx] = val
    full[:, idx] = val
    assert torch.equal(hb.gather(), full)
    hb[0, :, 1:3].copy_(torch.zeros(3, 2, 6))
    full[0, :, 1:3] = 0
    assert torch.equal(hb.gather(), full)
    assert torch.equal(hb.take(2, 5, "cpu"), full[..., 2:5])
    with pytest.raises(IndexError, match="split"):
        hb[:, :, :, 1]


def test_cli_mesh_fleet_model_matches_reference():
    """``--mesh 2x2:fleet,model`` on the CPU (four virtual devices, set
    from the spec) through the control loop: the reference's digest,
    per-tick counts and ledger; the groups' state in head blocks."""
    import test_torch_control_loop as tcl
    from repro.configs import get_config as jax_get_config
    from repro.models.model import make_model as jax_make_model
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import make_model
    import jax
    import jax.numpy as jnp

    jm = jax_make_model(jax_get_config("granite-3-8b").reduced(), tp=1)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    tm = make_model(get_config("granite-3-8b").reduced(), tp=1)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    args = serve.build_parser().parse_args(
        tcl.LOOP + ["--mesh", "2x2:fleet,model"])
    # uncached: tcl's cache is keyed without the mesh, and an entry made
    # here on this file's models would stand in for that file's own run
    ref = tcl.reference_loop(jm, jp, args)
    with meshlib.host_device_count(1):
        out = tcl.port_loop(tm, tp, args, ref)
    assert out["mesh"].shape == {"fleet": 2, "model": 2}
    tcl.assert_loops_match(out, ref)
    groups = list(out["fe"]._fleets.values())
    assert groups and all(g.heads == 2 for g in groups)
    assert serve.serve_mesh(args).size == 4
    assert parse_mesh_spec("2x2:fleet,model", device="cpu").size == 4
