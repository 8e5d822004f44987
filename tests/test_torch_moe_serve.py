"""The port's serving engine and control loop on the MoE family against the
reference, in one process.

Reduced grok-1-314b and llama4-maverick with the reference's weights
bridged in. MoE replicas admit exact-length prompts one at a time (expert
capacity scales with a padded bucket, so the reference keeps moe off the
bucketed and chunked paths), and under the async tick each single admit
registers its slot in the fleet's device operands after its own eager
sync. Drain mode, the async tick against its eager oracle, the standalone
engine and the control loop (``--arch grok-1-314b --policy ours
--autoscale gpso``) give the reference's token streams, finish clocks and
per-tick dispatch and sync counts, computed live on both sides; the loop
keeps the async tick's sync contract with the single admits' syncs
counted as the replicas' own.
"""
import dataclasses
import functools
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
from repro.models import make_model as jax_make_model
from repro.serving import ElasticClusterFrontend as JaxElastic
from repro.serving import ReplicaEngine as JaxReplica
from repro.serving import Request as JaxRequest
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models.model import make_model
from repro_torch.serving.elastic import (ElasticClusterFrontend,
                                         async_tick_violations)
from repro_torch.serving.engine import ReplicaEngine, Request
from test_torch_control_loop import (assert_loops_match, port_loop,
                                     reference_loop)
from test_torch_serve import _digest, _jax_drain
from test_torch_vlm import _one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
GROK, LLAMA4 = "grok-1-314b", "llama4-maverick-400b-a17b"
MAX_SEQ = 64
TICKS = 15


@functools.lru_cache(maxsize=None)
def _pair(name):
    jm = jax_make_model(jax_get_config(name).reduced(), tp=1)
    jp = jax.jit(jm.init, static_argnums=1)(jax.random.PRNGKey(0),
                                            jnp.float32)
    tm = make_model(get_config(name).reduced(), tp=1)
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@functools.lru_cache(maxsize=None)
def _reference_drain(name):
    jm, jp, _, _ = _pair(name)
    jfe, jreps = _jax_drain(jm, jp, 8, 0, "lc")
    return (_digest(jfe.finished), sum(r.steps for r in jreps),
            sum(r.prefill_dispatches for r in jreps),
            sum(r.prefill_traces for r in jreps))


@pytest.mark.parametrize("name,backend", [(GROK, "pallas"),
                                          (GROK, "einsum"),
                                          (LLAMA4, "pallas")])
def test_drain_mode_matches_reference(name, backend):
    """The reference at its default backend (einsum), the port at
    ``backend``: equal digests, decode steps and exact-length prefill
    dispatches (one a request)."""
    _, _, tm, tp = _pair(name)
    args = serve.build_parser().parse_args(
        ["--device", "cpu", "--requests", "8", "--replicas", "2",
         "--arch", name, "--policy", "lc", "--attn-backend", backend])
    fe, reps, _ = serve.run_drain_mode(args, tm.cfg, tm, tp)
    got = (_digest(fe.finished), sum(r.steps for r in reps),
           sum(r.prefill_dispatches for r in reps),
           sum(r.prefill_traces for r in reps))
    assert got == _reference_drain(name)
    assert len(fe.finished) == 8 and got[2] == 8


def _requests(cls, n=5, n_new=4, seed=11):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(1, 400, rng.integers(3, 9)).tolist(),
                max_new_tokens=n_new) for i in range(n)]


def _snap(reqs):
    return {r.rid: (tuple(r.output), r.finish_time, r.first_token_time)
            for r in reqs}


def _elastic_run(cls, replica_cls, model, params, async_tick, **kw):
    def factory(rid):
        return replica_cls(model, params, max_batch=2, max_seq=MAX_SEQ,
                           rid=rid, **kw)

    fe = cls(factory, 1, initial_replicas=2, seed=0, async_tick=async_tick)
    reqs = _requests(JaxRequest if cls is JaxElastic else Request)
    for r in reqs:
        fe.submit(r)
    fe.run_until_drained()
    return _snap(reqs)


def test_moe_single_admit_async_parity():
    """The mirror of tests/test_async_serve.py's: single admits (an eager
    prefill sync, then the slot's device operands registered through
    ``write_slot``) under the async tick give the eager oracle's streams
    and clocks -- and the reference's."""
    jm, jp, tm, tp = _pair(GROK)
    got = {a: _elastic_run(ElasticClusterFrontend, ReplicaEngine, tm, tp, a,
                           device="cpu") for a in (True, False)}
    assert got[True] == got[False]
    assert got[True] == _elastic_run(JaxElastic, JaxReplica, jm, jp, True)


def test_moe_defaults_to_exact_length_admission():
    """MoE replicas skip the bucketed path and drop a chunk length, as the
    reference's do; their exact-length admits give the reference's
    streams, and the model refuses a chunked prefill."""
    jm, jp, tm, tp = _pair(GROK)
    eng = ReplicaEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ, chunk_len=8,
                        device="cpu")
    jeng = JaxReplica(jm, jp, max_batch=2, max_seq=MAX_SEQ, chunk_len=8)
    assert not eng.bucket_prompts and eng.chunk_len == 0
    assert (jeng.bucket_prompts, jeng.chunk_len) == (False, 0)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 400, 5 + i).tolist() for i in range(2)]
    snaps = []
    for e, cls in ((eng, Request), (jeng, JaxRequest)):
        reqs = [cls(i, p, max_new_tokens=4) for i, p in enumerate(prompts)]
        for r in reqs:
            e.submit(r)
        for _ in range(40):
            e.step()
            if e.load == 0:
                break
        assert e.load == 0
        snaps.append(_snap(reqs))
    assert snaps[0] == snaps[1]
    assert eng.prefill_dispatches == jeng.prefill_dispatches == 2
    with pytest.raises(ValueError, match="chunked prefill unsupported"):
        tm.prefill_chunk(tp, eng.cache, torch.ones((1, 4), dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32),
                         torch.full((1,), 4, dtype=torch.int32))


def test_control_loop_matches_reference():
    """``--arch grok-1-314b --policy ours --autoscale gpso``: digest,
    per-tick replicas, fractions, dispatches and syncs equal to the
    reference's; every tick keeps the async tick's sync contract, the
    single admits' syncs counted as the replicas' own."""
    jm, jp, tm, tp = _pair(GROK)
    args = serve.build_parser().parse_args(
        ["--device", "cpu", "--policy", "ours", "--autoscale", "gpso",
         "--ticks", str(TICKS), "--arch", GROK])
    ref = reference_loop(jm, jp, args)
    out = port_loop(tm, tp, args, ref)
    assert_loops_match(out, ref)
    ticks = out["ticks"]
    assert async_tick_violations(ticks) == []
    singles = sum(t["replica_syncs"] for t in ticks)
    assert singles > 0
    assert async_tick_violations([dict(t, replica_syncs=0) for t in ticks])


@pytest.mark.parametrize("policy", ["ours", "lc"])
def test_cli_runs_llama4_on_cpu(policy, capsys):
    flags = ["--device", "cpu", "--arch", LLAMA4, "--policy", policy]
    flags += ["--autoscale", "gpso", "--ticks", "6"] if policy == "ours" \
        else ["--requests", "4", "--attn-backend", "einsum"]
    serve.main(flags)
    out = capsys.readouterr().out
    assert f"arch={LLAMA4}-reduced" in out
    assert ("balanced=True" in out) if policy == "ours" else \
        ("4/4 finished" in out)


def test_cli_drain_mode_grok(monkeypatch):
    """The command line serves grok-1-314b's reduced config on the CPU;
    with ``--device`` left at its default (cuda) and no card it raises."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", GROK, "--policy", "lc", "--requests", "4"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "4/4 finished" in out.stdout
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", GROK, "--policy", "lc", "--requests", "4"])


def test_int8_serve_state_for_moe():
    """The int8 KV pool is open to moe, as in the reference (dense and moe
    keep an attention pool); a replica with it serves the reference's
    int8 streams."""
    jm, jp, tm, tp = _pair(GROK)
    state = tm.init_serve_state(2, 16, "int8", device="cpu")
    assert state["k_q"].dtype == torch.int8
    snaps = []
    for cls, e in ((Request, ReplicaEngine(tm, tp, max_batch=2,
                                           max_seq=MAX_SEQ,
                                           cache_dtype="int8",
                                           device="cpu")),
                   (JaxRequest, JaxReplica(jm, jp, max_batch=2,
                                           max_seq=MAX_SEQ,
                                           cache_dtype="int8"))):
        reqs = _requests(cls, n=3)
        for r in reqs:
            e.submit(r)
        while e.load:
            e.step()
        snaps.append(_snap(reqs))
    assert snaps[0] == snaps[1]
