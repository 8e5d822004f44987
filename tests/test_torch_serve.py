"""Drain-mode serving of the port against the JAX package, in one process.

The same ``prompt_workload(seed)`` requests go through the JAX
``ClusterFrontend(policy="lc")`` of standalone replicas and through the
port's ``run_drain_mode`` on the CPU, with the reference's weights bridged
into the port. Both digests over (rid, output, first_token_time,
finish_time) are computed live here -- never pinned -- and the prefill
shape count and decode steps must match the reference's retrace count and
steps.
"""
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import prompt_workload as jax_prompt_workload
from repro.models import make_model as jax_make_model
from repro.serving.engine import ClusterFrontend as JaxFrontend
from repro.serving.engine import ReplicaEngine as JaxReplica
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import total_prefill_traces as jax_traces
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import make_model
from repro_torch.serving.engine import (FleetGroup, ReplicaEngine, Request,
                                        total_prefill_traces)
from test_torch_vlm import _one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def models():
    jm = jax_make_model(jax_get_config("granite-3-8b").reduced(), tp=1)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    tm = make_model(get_config("granite-3-8b").reduced(), tp=1)
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _digest(finished):
    rows = sorted((r.rid, tuple(r.output), r.first_token_time, r.finish_time)
                  for r in finished)
    return hashlib.sha256(repr(rows).encode()).hexdigest(), len(rows)


def _jax_drain(jm, jp, n, seed, policy, replicas=2, max_batch=4,
               max_seq=128):
    reps = [JaxReplica(jm, jp, max_batch=max_batch, max_seq=max_seq, rid=i)
            for i in range(replicas)]
    fe = JaxFrontend(reps, policy=policy, seed=seed)
    for w in jax_prompt_workload(jm.cfg.vocab_size, n, seed=seed):
        fe.submit(JaxRequest(w["rid"], w["prompt"],
                             max_new_tokens=w["max_new_tokens"]))
    fe.run_until_drained()
    return fe, reps


def _serve_one(eng, req_cls, n=4, seed=5):
    rng = np.random.default_rng(seed)
    reqs = [req_cls(i, rng.integers(1, 400, 3 + 5 * i).tolist(),
                    max_new_tokens=5) for i in range(n)]
    for r in reqs:
        eng.submit(r)
    for _ in range(30):
        eng.step()
        if eng.load == 0:
            break
    return {r.rid: (tuple(r.output), r.finish_time, r.first_token_time)
            for r in reqs}


@pytest.mark.parametrize("backend,seed,policy", [
    ("pallas", 0, "lc"), ("einsum", 0, "lc"), ("pallas", 3, "lc"),
    ("pallas", 1, "rr"), (None, 0, "lc")])
def test_drain_mode_matches_reference(models, backend, seed, policy):
    """The reference runs at its default backend (einsum); the port at the
    one asked for, or at its own default (pallas, the kernel path) when
    the flag is left out, as on both sides of the None case."""
    jm, jp, tm, tp = models
    jfe, jreps = _jax_drain(jm, jp, 12, seed, policy)
    flag = [] if backend is None else ["--attn-backend", backend]
    args = serve.build_parser().parse_args(
        ["--device", "cpu", "--requests", "12", "--replicas", "2",
         "--seed", str(seed), "--policy", policy] + flag)
    assert args.attn_backend == (backend or "pallas")
    fe, reps, _ = serve.run_drain_mode(args, tm.cfg, tm, tp)
    assert _digest(fe.finished) == _digest(jfe.finished)
    assert len(fe.finished) == 12
    assert sum(r.steps for r in reps) == sum(r.steps for r in jreps)
    assert total_prefill_traces(reps) == jax_traces(jreps)


def test_kernel_backend_matches_pallas_backend(models):
    """The port's kernel backend against the reference's Pallas
    flash-decode backend (interpret mode) at mixed per-slot cache depths,
    as tests/test_async_serve.py holds pallas to einsum."""
    jm, jp, tm, tp = models
    want = _serve_one(JaxReplica(jm, jp, max_batch=2, max_seq=32,
                                 attn_backend="pallas"), JaxRequest, n=3)
    got = _serve_one(ReplicaEngine(tm, tp, max_batch=2, max_seq=32,
                                   attn_backend="pallas", device="cpu"),
                     Request, n=3)
    assert got == want


def test_single_admit_path_matches_reference(models):
    """bucket_prompts=False: one exact-length prefill per request."""
    jm, jp, tm, tp = models
    jeng = JaxReplica(jm, jp, max_batch=2, max_seq=64, bucket_prompts=False)
    teng = ReplicaEngine(tm, tp, max_batch=2, max_seq=64,
                         bucket_prompts=False, device="cpu")
    assert _serve_one(teng, Request) == _serve_one(jeng, JaxRequest)
    assert teng.prefill_dispatches == jeng.prefill_dispatches == 4
    assert teng.prefill_traces == jeng.prefill_traces


def test_cli_drain_mode_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "6"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "6/6 finished" in out.stdout


def test_cli_takes_the_references_backend_names(capsys):
    """``--attn-backend pallas`` (the reference's name for the kernel path)
    serves; the port's old name ``kernel`` is refused by the parser."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--attn-backend", "pallas", "--requests", "2"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "2/2 finished" in out.stdout
    assert "attn-backend=pallas" in out.stdout
    with pytest.raises(SystemExit):
        serve.build_parser().parse_args(["--attn-backend", "kernel"])
    assert "invalid choice: 'kernel'" in capsys.readouterr().err


def test_cli_control_mode_not_yet_ported(capsys):
    """The control loop, its multi-cell federation, chunked prefill and
    the fleet mesh are ported (tests/test_torch_control_loop.py,
    tests/test_torch_cells.py, tests/test_torch_chunked_prefill.py hold
    them to the reference, sharded too): --chunk-len in the federation
    runs to a balanced ledger, and so does the federation over 2 virtual
    shards, every cell's groups split. --hierarchy without --cells > 1
    exits with the reference's message."""
    serve.main(["--device", "cpu", "--policy", "ours", "--cells", "2",
                "--chunk-len", "8", "--max-seq", "64", "--ticks", "6"])
    assert "balanced=True" in capsys.readouterr().out
    out = serve.main(["--device", "cpu", "--policy", "ours", "--cells", "2",
                      "--ticks", "6", "--devices", "2"])["fe"]
    text = capsys.readouterr().out
    assert "[serve] mesh: {'fleet': 2} over 2 device(s)" in text
    assert "balanced=True" in text and out.ledger.balanced()
    assert {g.shards for c in out.cells for g in c._fleets.values()} == {2}
    with pytest.raises(SystemExit, match="needs --cells > 1"):
        serve.main(["--device", "cpu", "--hierarchy"])


def test_cuda_requested_without_cuda_raises(models, monkeypatch):
    """No silent move to the CPU: asking for CUDA where there is none
    raises at every entry point."""
    _, _, tm, tp = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tm.init(seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        ReplicaEngine(tm, tp, max_batch=2, max_seq=32)


def test_unported_engine_options_raise(models):
    """chunk_len and the int8 cache are ported for the dense family and no
    longer raise (tests/test_torch_chunked_prefill.py and
    tests/test_torch_kv_quant.py hold them to the reference), a fleet
    group takes a fleet mesh (tests/test_torch_fleet_mesh.py) and refuses
    one without a 'fleet' axis, as the reference does, and a cache dtype
    the codec does not know is refused."""
    _, _, tm, tp = models
    assert ReplicaEngine(tm, tp, max_batch=2, max_seq=32, chunk_len=8,
                         device="cpu").chunk_len == 8
    eng = ReplicaEngine(tm, tp, max_batch=2, max_seq=32, cache_dtype="int8",
                        device="cpu")
    assert eng.cache["k_q"].dtype == torch.int8 and eng.chunk_len == 0
    g = FleetGroup(tm, tp, max_batch=2, max_seq=32, device="cpu",
                   mesh=make_mesh((2,), ("fleet",), devices=["cpu"] * 2))
    assert g.shards == 2 and len(g.parts) == 2
    with pytest.raises(ValueError, match="'fleet' axis"):
        FleetGroup(tm, tp, max_batch=2, max_seq=32, device="cpu",
                   mesh=make_mesh((1,), ("model",), devices=["cpu"]))
    with pytest.raises(ValueError, match="cache dtype"):
        ReplicaEngine(tm, tp, max_batch=2, max_seq=32, cache_dtype="int4",
                      device="cpu")
