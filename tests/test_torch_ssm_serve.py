"""The port's serving engine and control loop on the ssm and hybrid families
against the reference, in one process.

Reduced mamba2-1.3b and zamba2-2.7b with the reference's weights bridged
into the port. Drain mode and the single-cell control loop (``--policy
ours --autoscale gpso``, GPSO drawing through ``JaxKey``) must give the
reference's token streams, finish ticks, per-tick replica counts and
dispatch and sync counts, computed live on both sides. Two engine checks
have no counterpart in the reference's tests: a fleet prefill at a config
with more SSM heads than the length bucket must write every head of the
admitted rows' state (the attention caches alone have a sequence axis),
and a masked sub-step round keeps the other rows' SSM and conv state bit
for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import make_model as jax_make_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models.model import make_model
from repro_torch.serving.engine import FleetGroup, ReplicaEngine, Request
from test_torch_control_loop import (assert_loops_match,
                                     cached_reference_loop, port_loop)
from test_torch_serve import _digest, _jax_drain
from test_torch_vlm import _one_torch_thread  # noqa: F401

ARCHS = ["mamba2-1.3b", "zamba2-2.7b"]
TICKS = 25


def _pair(name, **changes):
    jcfg = dataclasses.replace(jax_get_config(name).reduced(), **changes)
    jm = jax_make_model(jcfg, tp=1)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    tm = make_model(dataclasses.replace(get_config(name).reduced(),
                                        **changes), tp=1)
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _pair(request.param)


def test_drain_mode_matches_reference(models):
    jm, jp, tm, tp = models
    jfe, jreps = _jax_drain(jm, jp, 10, 0, "lc")
    args = serve.build_parser().parse_args(
        ["--device", "cpu", "--requests", "10", "--replicas", "2",
         "--arch", tm.cfg.name, "--policy", "lc"])
    fe, reps, _ = serve.run_drain_mode(args, tm.cfg, tm, tp)
    assert _digest(fe.finished) == _digest(jfe.finished)
    assert len(fe.finished) == 10
    assert sum(r.steps for r in reps) == sum(r.steps for r in jreps)
    assert sum(r.prefill_dispatches for r in reps) == \
        sum(r.prefill_dispatches for r in jreps)


def test_control_loop_matches_reference(models):
    """``--arch <ssm or hybrid> --policy ours --autoscale gpso``: digest,
    per-tick replicas, fractions, dispatches and syncs equal to the
    reference's."""
    jm, jp, tm, tp = models
    args = serve.build_parser().parse_args(
        ["--device", "cpu", "--policy", "ours", "--autoscale", "gpso",
         "--ticks", str(TICKS), "--arch", tm.cfg.name])
    ref = cached_reference_loop(jm, jp, args)
    out = port_loop(tm, tp, args, ref)
    assert_loops_match(out, ref)
    assert len(out["ticks"]) == TICKS and out["fe"].replicas_spawned > 2


def test_control_loop_sharded_matches_reference(models):
    """The loop above over 2 virtual shards (``--devices 2``): the ssm and
    conv state of the slab rows split, scale-ups and drains move rows
    between shards, and the reference's loop is matched tick by tick."""
    jm, jp, tm, tp = models
    args = serve.build_parser().parse_args(
        ["--device", "cpu", "--policy", "ours", "--autoscale", "gpso",
         "--ticks", str(TICKS), "--arch", tm.cfg.name, "--devices", "2"])
    ref = cached_reference_loop(jm, jp, args)
    out = port_loop(tm, tp, args, ref)
    assert_loops_match(out, ref)
    assert out["fe"].shard_dispatches()[1] > out["fe"].decode_steps()


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("policy", ["ours", "lc"])
def test_cli_runs_on_cpu(name, policy, capsys):
    flags = ["--device", "cpu", "--arch", name, "--policy", policy]
    flags += ["--autoscale", "gpso", "--ticks", "6"] if policy == "ours" \
        else ["--requests", "6"]
    serve.main(flags)
    out = capsys.readouterr().out
    assert f"arch={name}-reduced" in out
    assert ("balanced=True" in out) if policy == "ours" else \
        ("6/6 finished" in out)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("async_mode", [True, False])
def test_fleet_prefill_writes_every_ssm_head(name, async_mode):
    """ssm_head_dim 16 makes H = 16 SSM heads, more than the smallest
    length bucket (8): a fleet prefill must still write all 16 heads (and
    the whole conv window) of each admitted row over the previous
    occupant's state, equal to a standalone prefill of the same prompt."""
    _, _, tm, tp = _pair(name, ssm_head_dim=16)
    assert tm.cfg.ssm_heads == 16
    engs = [ReplicaEngine(tm, tp, max_batch=2, max_seq=32, rid=i,
                          device="cpu") for i in range(2)]
    g = FleetGroup(tm, tp, max_batch=2, max_seq=32, async_mode=async_mode,
                   device="cpu")
    for e in engs:
        g.add(e)
    gen = torch.Generator().manual_seed(1)
    for s in g.slab.values():          # a previous occupant's state
        s.normal_(generator=gen)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 400, n).tolist() for n in (5, 3, 7, 2)]
    for i, p in enumerate(prompts):
        engs[i // 2].submit(Request(i, p, max_new_tokens=8))
    g.admit_round()
    g.reconcile()
    assert g.prefill_dispatches == 1       # all four in one bucket of 8
    for i, p in enumerate(prompts):
        _, want, _ = tm.prefill(
            tp, {"tokens": torch.tensor([p], dtype=torch.int32)},
            cache_len=len(p), cache_dtype=torch.float32)
        for k, s in g.slab.items():
            got = s[:, i]                  # member i // 2, slot i % 2
            if k.startswith("attn_"):
                got = got[:, :len(p)]
            torch.testing.assert_close(got, want[k][:, 0], atol=1e-5,
                                       rtol=1e-5, msg=f"{k} row {i}")


@pytest.mark.parametrize("name", ARCHS)
def test_masked_round_keeps_other_rows_bit_for_bit(name):
    """A sub-step round where one member of three steps: the SSM, conv
    (and attention) state of every other slab row stays bit for bit."""
    _, _, tm, tp = _pair(name)
    engs = [ReplicaEngine(tm, tp, max_batch=2, max_seq=32, rid=i,
                          device="cpu") for i in range(3)]
    g = FleetGroup(tm, tp, max_batch=2, max_seq=32, async_mode=True,
                   device="cpu")
    for e in engs:
        g.add(e)
    rng = np.random.default_rng(3)
    for i in range(6):
        engs[i // 2].submit(Request(i, rng.integers(1, 400, 4).tolist(),
                                    max_new_tokens=9))
    for e in engs:
        e.begin_step(admit=False)
    g.admit_round()
    g.decode_round()
    g.reconcile()
    before = {n: s.clone() for n, s in g.slab.items()}
    engs[1].begin_step(admit=False)
    g.decode_round({id(engs[1])})
    g.reconcile()
    rows = g._rows(1)
    assert {"ssm", "conv"} <= set(g.slab)
    for n, s in g.slab.items():
        keep = torch.ones(s.shape[1], dtype=torch.bool)
        keep[rows] = False
        assert torch.equal(s[:, keep], before[n][:, keep]), n
        assert not torch.equal(s[:, rows], before[n][:, rows]), n
