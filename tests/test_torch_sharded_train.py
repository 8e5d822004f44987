"""Sharded runs of the port (DTensor params over a ``torch.distributed``
``DeviceMesh``) held to the reference's unsharded ones, on the CPU: one
spawn of 8 gloo ranks, torch pinned to one thread a rank, runs every check
on its meshes -- the reference's own tests make its sharded runs equal to
its unsharded ones (tests/test_expert_parallel.py), so the port's sharded
step is held to the reference's single-device step on bridged weights
(``bridge.params_from_jax``), in f32.

  * one AdamW step of ``make_train_step(shard_fn=make_shard_fn(plan))`` on
    ``place_params`` weights and a ``place_batch`` batch: granite-3-8b and
    mamba2-1.3b on a (2, 2) ``data,model`` mesh of ranks 0-3, whisper-base
    and internvl2-2b on one of ranks 4-7; grok-1-314b and llama4 (capacity
    factor = the expert count, as the reference's test) on (4, 2) with
    expert sharding none and data, and on (2, 2, 2) ``data,expert,model``.
    The loss, ce, aux, grad norm and lr within 1e-5 of the reference's; every
    updated leaf within 1e-5 of the larger of the leaf's largest |value|
    and lr wherever the reference's gradient is above 1e-3 of the leaf's
    largest (or of 1e-3 of the tree's, for a leaf whose gradient is zero
    but for rounding) and above 1e-5 (Adam's first step is g / (|g| +
    eps), nearly a sign: a gradient that small may round either way on
    another reduction order, or sit near eps, so there it is held to the
    step's own bound, 2 x lr); and, since that step hardly depends on the
    gradient's size, every element of both moments, (1 - b1) g and
    (1 - b2) g^2, within 1e-5 of its leaf's largest, or 1e-7 of the
    tree's largest where that is more (f32's rounding of the largest
    gradient): a gradient off by a factor, as a missing or doubled
    reduction over a mesh axis gives, fails there;
  * elastic: granite's params placed on ``elastic_remesh(4, 2)``,
    resharded onto ``survivors_mesh(mesh, [6], 2)`` -- (3, 2) -- equal
    bit for bit; a (3, 3) remesh and a (4, 4) ``make_device_mesh`` of the
    8-rank group raise;
  * ``make_gossip_allreduce`` and ``psum_average_grads`` on an 8-rank
    ``data`` mesh give tests/test_gossip_mesh.py's values (every row the
    mean, 3.5);
  * a serve-mode prefill and one decode of granite on (2, 2) (weights
    whole over data, KV caches split over batch and kv heads; the fresh
    state laid out through ``shard_fn``'s "serve_state") equal the
    reference's prefill and decode of the same tokens, logits and every
    cache leaf, within 1e-5 of the largest;
  * ``comm_bytes`` counts a redistribution's all-gather, all-reduce and
    reduce-scatter by ``collective_bytes``'s kinds and ring factors;
  * a checkpoint of granite's sharded train state on (4, 2), saved by
    every rank and written by rank 0, holds the files an unsharded save
    of the same values holds (arrays, names, dtypes, the manifest but for
    its time); the reference's ``restore_latest`` restores them equal;
    the step after ``restore_latest`` and ``place_params`` equals the
    uninterrupted one bit for bit.

While the ranks run, this process computes the reference's steps.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models.model import make_model as jax_make_model
from repro.models.model import make_train_step as jax_make_train_step
from repro.models.optim import AdamW as JaxAdamW
from repro_torch.bridge import params_from_jax

SRC = Path(__file__).resolve().parent.parent / "src"
B, S = 8, 16
LR = 1e-3
RTOL = 1e-5
# a gradient element below this share of its leaf's largest sits at the
# rounding noise of a reduction order: Adam's first step may flip it
COND = 1e-3
# ... of the leaf's largest, or of this share of the tree's largest for a
# leaf whose gradient is zero but for rounding (a key bias)
NOISE_FLOOR = 1e-3
# ... and at least this: near AdamW's eps (1e-8) the step g / (|g| + eps)
# moves with g's own rounding
EPS_REGIME = 1e-5
# a leaf's moments are held to RTOL of their largest, but no tighter than
# RTOL x this share of the tree's largest = 1e-7 of it, f32's epsilon at
# the largest gradient: below that an element is rounding (a key bias's
# gradient is zero but for rounding; a per-head leaf of mamba2 is a sum
# that cancels to 1e-3 of the largest, its error 2e-8 of the largest). A
# leaf wrong by a factor fails wherever its largest exceeds 1e-7 of the
# tree's
MOMENT_FLOOR = 1e-2
# (job, arch, mesh, expert sharding)
JOBS = [("granite", "granite-3-8b", "A", "none"),
        ("mamba2", "mamba2-1.3b", "A", "none"),
        ("whisper", "whisper-base", "B", "none"),
        ("internvl2", "internvl2-2b", "B", "none"),
        ("grok", "grok-1-314b", "4x2", "none"),
        ("grok_ep", "grok-1-314b", "4x2", "data"),
        ("llama4", "llama4-maverick-400b-a17b", "4x2", "none"),
        ("llama4_ep", "llama4-maverick-400b-a17b", "4x2", "data"),
        ("grok_emesh", "grok-1-314b", "2x2x2", "none"),
        ("llama4_emesh", "llama4-maverick-400b-a17b", "2x2x2", "none")]

_RANKS = r"""
import dataclasses, os, pickle, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return full(tree).detach().numpy()


def config(arch):
    from repro_torch.configs import get_config
    c = get_config(arch).reduced()
    if c.uses_moe:
        c = dataclasses.replace(c, capacity_factor=float(c.num_experts))
    return c


def train_job(arch, mesh, es, inputs):
    from repro_torch.bridge import params_from_jax
    from repro_torch.distributed import ShardPlan, make_shard_fn, place_params
    from repro_torch.distributed.sharding import place_batch
    from repro_torch.models.model import make_model, make_train_step
    from repro_torch.models.optim import AdamW

    model = make_model(config(arch), tp=2)
    plan = ShardPlan(mesh, "train", es)
    params = place_params(plan, params_from_jax(inputs["params"], "cpu"))
    batch = place_batch(plan, {k: torch.from_numpy(v)
                               for k, v in inputs["batch"].items()})
    opt = AdamW(lr=LR)
    p2, o2, m = make_train_step(model, opt, make_shard_fn(plan))(
        params, opt.init(params), batch)
    return {"metrics": {k: float(full(v)) for k, v in m.items()},
            "params": to_numpy(p2), "mu": to_numpy(o2["mu"]),
            "nu": to_numpy(o2["nu"])}


def decode_job(mesh, inputs):
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.bridge import params_from_jax
    from repro_torch.distributed import ShardPlan, make_shard_fn, place_params
    from repro_torch.distributed.sharding import place_batch
    from repro_torch.models.model import make_decode_step, make_model

    model = make_model(config("granite-3-8b"), tp=2)
    plan = ShardPlan(mesh, "serve")
    shard_fn = make_shard_fn(plan)
    params = place_params(plan, params_from_jax(inputs["params"], "cpu"))
    batch = place_batch(plan, {"tokens": torch.from_numpy(
        inputs["batch"]["tokens"])})
    with torch.no_grad():
        with implicit_replication():
            logits, state, pos = model.prefill(
                params, batch, cache_len=S + 4, cache_dtype=torch.float32,
                shard_fn=shard_fn, attn_backend="einsum")
        out = {"prefill": to_numpy(dict(state, logits=logits, pos=pos)),
               "cache_layout": str(tuple(state["k"].placements))}
        rows = place_batch(plan, {"tokens": torch.from_numpy(inputs["next"]),
                                  "pos": full(pos)})
        logits, state = make_decode_step(model, shard_fn,
                                         attn_backend="einsum")(
            params, state, rows["tokens"], rows["pos"])
        out["decode"] = to_numpy(dict(state, logits=logits))
    return out


def elastic_job(mesh, inputs):
    from repro_torch.bridge import params_from_jax
    from repro_torch.core.tree import leaves
    from repro_torch.distributed import (ShardPlan, place_params,
                                         reshard_params, survivors_mesh)

    from repro_torch.distributed import elastic_remesh
    from repro_torch.launch.mesh import make_device_mesh

    params = params_from_jax(inputs["params"], "cpu")
    grown = elastic_remesh(4, 2, device="cpu")
    placed = place_params(ShardPlan(grown, "train"), params)
    small = survivors_mesh(grown, [6], 2)
    moved = reshard_params(placed, ShardPlan(small, "train"))
    out = {"shape": [int(s) for s in small.mesh.shape],
           "grown": grown.mesh.tolist() == mesh.mesh.tolist()}
    for build in (lambda: elastic_remesh(3, 3, device="cpu"),
                  lambda: make_device_mesh((4, 4), ("data", "model"),
                                           device="cpu")):
        try:
            build()
            out.setdefault("refused", []).append(False)
        except (ValueError, RuntimeError):
            out.setdefault("refused", []).append(True)
    if small.get_coordinate() is not None:
        out["equal"] = all(torch.equal(full(a), b) for a, b in
                           zip(leaves(moved), leaves(params)))
        out["split"] = any(tuple(x.to_local().shape) != tuple(x.shape)
                           for x in leaves(moved))
    return out


def ckpt_job(mesh, inputs, path):
    # granite's train state after one sharded step, saved (every rank),
    # restored whole, re-placed with place_params and stepped again,
    # beside the uninterrupted second step
    from repro_torch.bridge import params_from_jax
    from repro_torch.checkpoint.manager import restore_latest, save_checkpoint
    from repro_torch.core.tree import leaves
    from repro_torch.distributed import ShardPlan, make_shard_fn, place_params
    from repro_torch.distributed.sharding import place_batch
    from repro_torch.models.model import make_model, make_train_step
    from repro_torch.models.optim import AdamW

    model = make_model(config("granite-3-8b"), tp=2)
    plan = ShardPlan(mesh, "train")
    params = place_params(plan, params_from_jax(inputs["params"], "cpu"))
    batch = place_batch(plan, {k: torch.from_numpy(v)
                               for k, v in inputs["batch"].items()})
    opt = AdamW(lr=LR)
    step = make_train_step(model, opt, make_shard_fn(plan))
    p1, o1, _ = step(params, opt.init(params), batch)
    state = {"params": p1, "opt": o1}
    d = os.path.join(path, "ckpt")
    save_checkpoint(d, 1, state)
    p2, _, m2 = step(p1, o1, batch)
    n, got = restore_latest(d, state)
    resumed = {"params": place_params(plan, got["params"]),
               "opt": dict(got["opt"], mu=place_params(plan, got["opt"]["mu"]),
                           nu=place_params(plan, got["opt"]["nu"]))}
    rp2, _, rm2 = step(resumed["params"], resumed["opt"], batch)
    return {"dir": d, "restored_step": n, "state": to_numpy(state),
            "split": any(tuple(x.to_local().shape) != tuple(x.shape)
                         for x in leaves(p1)),
            "whole_on_restore": not any(hasattr(x, "full_tensor")
                                        for x in leaves(got)),
            "metrics": [{k: float(full(v)) for k, v in m.items()}
                        for m in (m2, rm2)],
            "params_equal": all(torch.equal(full(a), full(b)) for a, b in
                                zip(leaves(p2), leaves(rp2)))}


def gossip_job(mesh, rank):
    from torch.distributed.tensor import DTensor
    from repro_torch.core.decentralized import (make_gossip_allreduce,
                                                psum_average_grads)
    drift = torch.arange(8.0)[:, None] * torch.ones((8, 16))
    out = make_gossip_allreduce(mesh, "data")({"w": drift})["w"]
    g = psum_average_grads({"w": drift[rank]}, "data", mesh)["w"]
    return {"avg": out.to_local().tolist(), "grads": g.tolist(),
            "avg_layout": str(tuple(out.placements))}


def comm_job(mesh):
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor, DTensor)
    from repro_torch.distributed.sharding import comm_bytes

    x = distribute_tensor(torch.ones(16, 8), mesh, [Shard(0), Replicate()])
    with comm_bytes() as gathered:
        x.redistribute(mesh, [Replicate(), Replicate()])
    p = DTensor.from_local(torch.ones(16, 8), mesh, [Partial(), Replicate()])
    with comm_bytes() as reduced:
        p.redistribute(mesh, [Replicate(), Replicate()])
    with comm_bytes() as scattered:
        p.redistribute(mesh, [Shard(0), Replicate()])
    return {"gathered": gathered, "reduced": reduced, "scattered": scattered}


def run(rank, path, port):
    global JOBS, LR, S
    with open(os.path.join(path, "jobs.pkl"), "rb") as f:
        JOBS, LR, S = pickle.load(f)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=8)
    from torch.distributed.device_mesh import DeviceMesh
    import repro_torch.models.model  # noqa: F401 (imported while waiting)
    ranks = torch.arange(8)
    meshes = {"A": DeviceMesh("cpu", ranks[:4].reshape(2, 2),
                              mesh_dim_names=("data", "model")),
              "B": DeviceMesh("cpu", ranks[4:].reshape(2, 2),
                              mesh_dim_names=("data", "model")),
              "4x2": DeviceMesh("cpu", ranks.reshape(4, 2),
                                mesh_dim_names=("data", "model")),
              "2x2x2": DeviceMesh("cpu", ranks.reshape(2, 2, 2),
                                  mesh_dim_names=("data", "expert", "model")),
              "8": DeviceMesh("cpu", ranks, mesh_dim_names=("data",))}
    # the test process writes the inputs while the ranks start
    import time
    ready = os.path.join(path, "inputs.ready")
    while not os.path.exists(ready):
        time.sleep(0.1)
    with open(os.path.join(path, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    out = {}
    for job, arch, mesh, es in JOBS:
        if meshes[mesh].get_coordinate() is not None:
            out[job] = train_job(arch, meshes[mesh], es, inputs[job])
    if meshes["A"].get_coordinate() is not None:
        out["decode"] = decode_job(meshes["A"], inputs["granite"])
    out["elastic"] = elastic_job(meshes["4x2"], inputs["granite"])
    out["ckpt"] = ckpt_job(meshes["4x2"], inputs["granite"], path)
    out["gossip"] = gossip_job(meshes["8"], rank)
    out["comm"] = comm_job(meshes["4x2"])
    with open(os.path.join(path, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    path, port = sys.argv[1], int(sys.argv[2])
    mp.spawn(run, args=(path, port), nprocs=8)
"""


def _jax_config(arch):
    c = jax_get_config(arch).reduced()
    if c.uses_moe:
        c = dataclasses.replace(c, capacity_factor=float(c.num_experts))
    return c


def _batch(c, seed):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, c.vocab_size, (B, S)).astype(np.int32)}
    if c.family == "vlm":
        b["patch_embeds"] = (rng.standard_normal(
            (B, c.num_patches, c.d_model)) * 0.1).astype(np.float32)
    if c.family == "audio":
        b["frame_embeds"] = (rng.standard_normal(
            (B, c.encoder_seq_len, c.d_model)) * 0.1).astype(np.float32)
    return b


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results merged, the reference's steps by job)."""
    path = tmp_path_factory.mktemp("sharded")
    with open(path / "jobs.pkl", "wb") as f:
        pickle.dump((JOBS, LR, S), f)
    (path / "ranks.py").write_text(_RANKS)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, str(path / "ranks.py"),
                             str(path), str(_free_port())], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    archs = sorted({arch for _, arch, _, _ in JOBS})
    models, inputs = {}, {}
    for i, arch in enumerate(archs):
        c = _jax_config(arch)
        models[arch] = jax_make_model(c, tp=2)
        p = models[arch].init(jax.random.PRNGKey(0), jnp.float32)
        inputs[arch] = {"params": jax.tree.map(np.asarray, p),
                        "batch": _batch(c, 10 + i),
                        "next": np.random.default_rng(30 + i).integers(
                            0, c.vocab_size, (B, 1)).astype(np.int32)}
    with open(path / "inputs.pkl", "wb") as f:
        pickle.dump({job: inputs[arch] for job, arch, _, _ in JOBS}, f)
    (path / "inputs.ready").touch()
    # the reference's single-device steps, meanwhile
    ref = {}
    opt = JaxAdamW(lr=LR)
    for arch in archs:
        step = jax.jit(jax_make_train_step(models[arch], opt))
        p = jax.tree.map(jnp.asarray, inputs[arch]["params"])
        p2, o2, m = step(p, opt.init(p), {k: jnp.asarray(v) for k, v in
                                          inputs[arch]["batch"].items()})
        ref[arch] = {"params": params_from_jax(
            jax.tree.map(np.asarray, p2), "cpu"),
            "mu": params_from_jax(jax.tree.map(np.asarray, o2["mu"]), "cpu"),
            "nu": params_from_jax(jax.tree.map(np.asarray, o2["nu"]), "cpu"),
            "metrics": {k: float(v) for k, v in m.items()}}
    # the reference's prefill and one einsum decode of granite's batch
    g = inputs["granite-3-8b"]
    p = jax.tree.map(jnp.asarray, g["params"])
    jl, jc, jpos = models["granite-3-8b"].prefill(
        p, {"tokens": jnp.asarray(g["batch"]["tokens"])}, cache_len=S + 4,
        cache_dtype=jnp.float32)
    ref["prefill"] = dict(jax.tree.map(np.asarray, jc),
                          logits=np.asarray(jl), pos=np.asarray(jpos))
    jl, jc = models["granite-3-8b"].decode(p, jc, jnp.asarray(g["next"]),
                                           jpos)
    ref["decode"] = dict(jax.tree.map(np.asarray, jc), logits=np.asarray(jl))
    try:
        _, err = proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        _, err = proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    merged = {}
    for r in range(8):
        with open(path / f"rank{r}.pkl", "rb") as f:
            got = pickle.load(f)
        for k, v in got.items():
            merged.setdefault(k, {})[r] = v
    return merged, ref


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, list):
        return [x for v in t for x in _leaves(v)]
    return [t]


@pytest.mark.parametrize("job", [j[0] for j in JOBS])
def test_sharded_step_matches_reference(runs, job):
    merged, ref = runs
    arch = dict((j[0], j[1]) for j in JOBS)[job]
    results = list(merged[job].values())
    want = ref[arch]
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        for res in results:
            np.testing.assert_allclose(res["metrics"][k], want["metrics"][k],
                                       rtol=RTOL, atol=1e-30, err_msg=k)
    got = _leaves(results[0]["params"])
    exp = [t.numpy() for t in _leaves(want["params"])]
    mus = [t.numpy() for t in _leaves(want["mu"])]
    assert len(got) == len(exp)
    grads = [np.abs(mu) / 0.1 for mu in mus]    # mu after a step: 0.1 g
    floor = NOISE_FLOOR * max(g.max(initial=0.0) for g in grads)
    for g, e, grad in zip(got, exp, grads):
        assert g.shape == e.shape
        sure = grad >= max(COND * max(grad.max(initial=0.0), floor),
                           EPS_REGIME)
        diff = np.abs(g - e)
        scale = max(np.abs(e).max(initial=0.0), LR)
        assert diff[sure].max(initial=0.0) <= RTOL * scale
        assert diff.max(initial=0.0) <= 2 * LR
    # every rank of the mesh holds the same whole params
    for res in results[1:]:
        assert all(np.array_equal(a, b) for a, b in
                   zip(_leaves(res["params"]), got))
    # the moments after one step are (1 - b1) g and (1 - b2) g^2: every
    # gradient element, compared directly with no mask
    for name in ("mu", "nu"):
        want_m = [t.numpy() for t in _leaves(want[name])]
        top = max(np.abs(w).max(initial=0.0) for w in want_m)
        for res in results:
            got_m = _leaves(res[name])
            assert len(got_m) == len(want_m)
            for g, w in zip(got_m, want_m):
                scale = max(np.abs(w).max(initial=0.0), MOMENT_FLOOR * top)
                assert np.abs(g - w).max(initial=0.0) <= RTOL * scale, name


def test_sharded_decode_matches_unsharded(runs):
    """The sharded prefill and decode against the reference's unsharded
    ones on the same weights and tokens."""
    merged, ref = runs
    for res in merged["decode"].values():
        for phase in ("prefill", "decode"):
            got, want = dict(res[phase]), dict(ref[phase])
            assert set(got) == set(want), phase
            if phase == "prefill":
                # the reference's prefill gives one position for an
                # unpadded batch, the port's one a row
                np.testing.assert_array_equal(
                    got.pop("pos"), np.broadcast_to(want.pop("pos"), (B,)))
            for k, w in want.items():
                assert got[k].shape == w.shape, (phase, k)
                err = np.abs(got[k] - w).max()
                assert err <= RTOL * np.abs(w).max(), (phase, k, err)
        # batch over data, kv heads over model (the cache's dims 1 and 3)
        assert res["cache_layout"] == "(Shard(dim=1), Shard(dim=3))"


def test_elastic_reshard_is_bit_exact(runs):
    merged, _ = runs
    el = merged["elastic"]
    assert all(r["shape"] == [3, 2] and r["grown"] for r in el.values())
    # 9 and 16 ranks asked of an 8-rank group: refused, no fallback
    assert all(r["refused"] == [True, True] for r in el.values())
    kept = [r for r in el.values() if "equal" in r]
    assert len(kept) == 6
    assert all(r["equal"] and r["split"] for r in kept)


def test_gossip_and_grad_average_on_mesh(runs):
    merged, _ = runs
    for rank, res in merged["gossip"].items():
        np.testing.assert_allclose(res["avg"], np.full((1, 16), 3.5))
        np.testing.assert_allclose(res["grads"], np.full(16, 3.5))
        assert res["avg_layout"] == "(Shard(dim=0),)"


def test_sharded_save_holds_the_unsharded_files(runs, tmp_path):
    """The sharded save's files against an unsharded save of the same
    values made here: the same arrays under the same names and dtypes,
    and the same manifest but for ``time``."""
    from repro_torch.checkpoint.manager import save_checkpoint
    import torch

    merged, _ = runs
    res = merged["ckpt"][0]
    assert all(r["split"] for r in merged["ckpt"].values())
    whole = _torch_tree(res["state"])
    save_checkpoint(str(tmp_path), 1, whole)
    (sharded,), (plain,) = ([os.path.join(d, n) for n in os.listdir(d)
                             if n.startswith("step_")]
                            for d in (res["dir"], str(tmp_path)))
    with np.load(os.path.join(sharded, "leaves.npz")) as a, \
            np.load(os.path.join(plain, "leaves.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    mans = []
    for d in (sharded, plain):
        with open(os.path.join(d, "manifest.json")) as f:
            man = json.load(f)
        man.pop("time")
        mans.append(man)
    assert mans[0] == mans[1]
    assert not any(n.startswith(".tmp_") for n in os.listdir(res["dir"]))
    assert isinstance(whole["opt"]["step"], torch.Tensor)


def test_reference_restores_the_sharded_save(runs):
    """The reference's ``restore_latest`` gives the sharded save back
    equal to the state's whole values."""
    from repro.checkpoint import manager as jckpt

    merged, _ = runs
    res = merged["ckpt"][0]
    like = jax.tree.map(jnp.asarray, res["state"])
    step, got = jckpt.restore_latest(res["dir"], like)
    assert step == 1
    want = jax.tree.leaves(res["state"])
    got = jax.tree.leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)


def test_resumed_sharded_step_equals_uninterrupted(runs):
    """On every rank: the restored leaves are whole tensors, and the step
    after ``place_params`` gives the uninterrupted step's metrics and
    params bit for bit."""
    merged, _ = runs
    assert len(merged["ckpt"]) == 8
    for res in merged["ckpt"].values():
        assert res["restored_step"] == 1 and res["whole_on_restore"]
        straight, resumed = res["metrics"]
        assert straight == resumed
        assert res["params_equal"]


def _torch_tree(t):
    import torch
    if isinstance(t, dict):
        return {k: _torch_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_torch_tree(v) for v in t]
    return torch.from_numpy(np.array(t))


def test_comm_bytes_counts_redistributions(runs):
    merged, _ = runs
    from repro_torch.distributed.sharding import collective_bytes
    keys = set(collective_bytes(""))
    whole = 16 * 8 * 4
    for res in merged["comm"].values():
        for c in res.values():
            assert set(c) == keys
        assert res["gathered"]["all-gather"] == whole
        assert res["gathered"]["total"] == whole
        assert res["reduced"]["all-reduce"] == 2 * whole
        assert res["scattered"]["reduce-scatter"] == whole / 4
