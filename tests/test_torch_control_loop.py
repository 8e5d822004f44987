"""The port's single-cell control loop against the reference, in one process.

The reference's stack is built exactly as ``repro.launch.serve.
run_control_loop`` builds it (``--policy ours --autoscale gpso``: the
elastic frontend of heterogeneous replicas with fleet batching and the
async tick, the GCN+DDPG balancer, the GPSO autoscaler, the bursty trace)
and driven for ``TICKS`` ticks, then drained. The port runs its own
``run_control_loop`` with the same flags, the reference's model and actor
weights bridged in, and GPSO drawing through ``JaxKey``. The digest over
(rid, tier, output, arrival, first_token_time, finish_time) is computed
live on both sides and must be equal, as must the per-tick replica counts,
dispatch and sync counts; the routing fractions agree within 1e-6.
``reference_loop``, ``port_loop`` and ``assert_loops_match`` take every
flag of the loop (cells, hierarchy, clients, decode blocks, chunked
prefill, tiers, chaos, the serving mesh) and serve the other parity tests
of the serve flags; ``cached_reference_loop`` runs the reference once a
flag set, so a file's sharded runs (``--devices N``: N virtual CPU shards)
are held to the reference run its unsharded test made.
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

from repro.configs import get_config as jax_get_config
from repro.configs.paper_cluster import ClusterConfig as JaxClusterConfig
from repro.control import (CellController, CellRouter, GlobalPlanner,
                           MultiCellBackend, PlaneSupervisor)
from repro.control.plane import ControlPlane as JaxPlane
from repro.core import balancer as jbal
from repro.models import make_model as jax_make_model
from repro.launch.serve import _parse_timeout
from repro.serving import ChaosSchedule as JaxChaos
from repro.serving import ElasticClusterFrontend as JaxElastic
from repro.serving import ReplicaEngine as JaxReplica
from repro.serving import Request as JaxRequest
from repro.workload import ClientPool as JaxPool
from repro.workload import TraceConfig, generate_trace
from repro.workload import parse_tiers as jax_parse_tiers
from repro_torch.bridge import params_from_jax, rl_from_jax
from repro_torch.configs import get_config
from repro_torch.configs.paper_cluster import ClusterConfig
from repro_torch.core.balancer import RLBalancer
from repro_torch.launch import mesh, serve
from repro_torch.models.model import make_model
from repro_torch.serving.elastic import async_tick_violations
from test_torch_control import JaxKey, _np
from test_torch_vlm import _one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
TICKS = 25


@pytest.fixture(scope="module")
def models():
    jm = jax_make_model(jax_get_config("granite-3-8b").reduced(), tp=1)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    tm = make_model(get_config("granite-3-8b").reduced(), tp=1)
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _cluster(cls, args):
    multi = args.cells > 1
    return cls(num_nodes=args.cells if multi else args.nodes, horizon=8,
               forecast_window=16, provisioning_delay=args.provision_delay,
               max_replicas_per_node=(args.nodes * args.max_replicas
                                      if multi else args.max_replicas),
               min_replicas_per_node=1, scale_interval=5, cooldown=8,
               straggler_prob=0.0, node_mtbf=1e12)


def reference_loop(jm, jp, args) -> dict:
    """``repro.launch.serve.run_control_loop`` over ``jm``/``jp`` with the
    serve flags ``args`` -- one cell or ``--cells``, ``--hierarchy``,
    ``--clients``, ``--decode-block``, tiers and chaos -- returning the
    frontend, the balancer, the pool, the supervisor and the per-tick
    record."""
    tiers = jax_parse_tiers(args.tiers)
    multi = args.cells > 1
    ccfg = _cluster(JaxClusterConfig, args)
    rng = np.random.default_rng(args.seed)

    def make_replica(rid):
        speed = float(rng.choice([0.7, 1.0, 1.4]))
        mb = int(rng.choice([max(2, args.max_batch // 2), args.max_batch]))
        return JaxReplica(jm, jp, max_batch=mb, max_seq=args.max_seq,
                          rid=rid, speed=speed, tiers=tiers,
                          chunk_len=args.chunk_len)

    def request_factory(rid, tick):
        plen = int(rng.integers(2, 12))
        req = JaxRequest(rid, rng.integers(1, jm.cfg.vocab_size,
                                           plen).tolist(),
                         max_new_tokens=int(rng.integers(4, 12)))
        if len(tiers) > 1:
            req.tier = tiers.sample(rng)
        return req

    chaos = JaxChaos.parse(args.chaos) if args.chaos else None

    def build_cell(cell_chaos):
        return JaxElastic(
            make_replica, args.nodes, initial_replicas=args.replicas,
            provisioning_delay=args.provision_delay,
            max_replicas_per_node=args.max_replicas,
            failure_rate=args.failure_rate,
            request_factory=request_factory, seed=args.seed,
            est_tokens=8.0, fleet_batch=not args.no_fleet,
            fleet_prefill=not args.no_fleet_prefill,
            async_tick=not args.no_async, decode_block=args.decode_block,
            tiers=tiers, preempt_notice=args.preempt_notice,
            chaos=cell_chaos)

    if multi:
        fe = MultiCellBackend(
            [build_cell(chaos if c == 0 else None)
             for c in range(args.cells)],
            tiers=tiers,
            router=CellRouter(args.cells, tiers=tiers,
                              shed_threshold=args.shed_threshold or None,
                              adaptive=not args.static_split),
            chaos=JaxChaos.parse(args.cell_chaos) if args.cell_chaos
            else None, request_factory=request_factory, seed=args.seed)
    else:
        fe = build_cell(chaos)
    pool = None
    if args.clients > 0:
        pool = JaxPool(fe, args.clients, request_factory=request_factory,
                       think_time=args.think_time,
                       timeout=_parse_timeout(args.timeout),
                       max_retries=args.retries, spawn_rate=args.spawn_rate,
                       seed=args.seed + 1)
    rl = jbal.RLBalancer(ccfg, 4 + ccfg.horizon, seed=args.seed)
    arrivals = generate_trace(TraceConfig(
        ticks=args.ticks, base_rate=args.rate,
        diurnal_period=max(args.ticks, 2)), seed=args.seed)["arrivals"]
    plane = JaxPlane(ccfg, fe, balancer="rl",
                     scaler="none" if args.hierarchy else args.autoscale,
                     unit_capacity=args.max_batch / 8.0, rl=rl,
                     forecast_scale=float(arrivals.mean()), seed=args.seed,
                     init_arrival=float(arrivals[:5].mean()))
    sup = None
    if args.hierarchy:
        cap = args.nodes * args.max_replicas
        sup = PlaneSupervisor(
            fe, GlobalPlanner(args.cells, total_budget=args.cells * cap,
                              max_per_cell=cap,
                              lease_slack=args.lease_slack),
            [CellController(fe, c) for c in range(args.cells)],
            plane=plane, plan_interval=args.plan_interval_global)
    ticks = []
    for t in range(args.ticks):
        if pool is not None:
            pool.tick()
        rate = 0.0 if pool is not None else float(arrivals[t])
        if sup is not None:
            m = sup.step(rate)
        elif getattr(fe, "plane_alive", True):
            m = plane.step(rate)
        else:
            m = fe.tick(rate)
        ticks.append({"replicas": m["active_replicas"].tolist(),
                      "fractions": plane.fractions.copy(),
                      "decode_dispatches": m["decode_dispatches"],
                      "prefill_dispatches": m["prefill_dispatches"],
                      "syncs": m["syncs"]})
    if pool is not None:
        pool.quiesce()
    fe.run_until_drained()
    if pool is not None:
        pool.finalize()
    return {"fe": fe, "rl": rl, "ticks": ticks, "pool": pool, "sup": sup}


_REFERENCE_RUNS: dict = {}


def cached_reference_loop(jm, jp, args) -> dict:
    """``reference_loop`` once a config and flag set in this process.
    ``--devices`` and ``--mesh`` are left out of the key: the reference's
    sharded loop equals its unsharded one (tests/test_fleet_shard.py), so
    a sharded port run is held to the run of the same flags without
    them."""
    flags = {k: v for k, v in vars(args).items()
             if k not in ("devices", "mesh")}
    key = (repr(jm.cfg), repr(sorted(flags.items())))
    if key not in _REFERENCE_RUNS:
        _REFERENCE_RUNS[key] = reference_loop(jm, jp, args)
    return _REFERENCE_RUNS[key]


def port_loop(tm, tp, args, ref) -> dict:
    """The port's ``run_control_loop`` with the reference's actor weights
    bridged in, GPSO drawing through ``JaxKey`` and the serving mesh that
    ``--devices`` / ``--mesh`` ask for (under ``"mesh"`` in the result)."""
    rl = RLBalancer(_cluster(ClusterConfig, args), 4 + 8, seed=args.seed,
                    device="cpu",
                    state=rl_from_jax(_np(ref["rl"].state), "cpu"))
    mesh = serve.serve_mesh(args)
    out = serve.run_control_loop(
        args, tm.cfg, tm, tp, rl=rl,
        scaler_key=JaxKey(jax.random.PRNGKey(args.seed)), mesh=mesh)
    return dict(out, mesh=mesh)


def assert_loops_match(out, ref):
    """Streams, finish clocks, ledger terminals, per-tick replicas,
    dispatch and sync counts exact; the routing fractions within 1e-6 (the
    reference's jitted GPSO rounds the last ulp of a fitness differently);
    the clients' and the hierarchy's own reports exact. The distinct
    prefill shapes (the reference's compile count) only when ``out`` is
    unsharded: a shape holds the slab's capacity, which a mesh rounds to a
    multiple of its shards, so a sharded run compiles at capacities the
    unsharded ``ref`` never saw, the reference's own sharded run too."""
    fe, jfe = out["fe"], ref["fe"]
    assert _digest(fe) == _digest(jfe)
    assert len(out["ticks"]) == len(ref["ticks"])
    for got, want in zip(out["ticks"], ref["ticks"]):
        np.testing.assert_allclose(got["fractions"], want["fractions"],
                                   atol=1e-6)
        for k in ("replicas", "decode_dispatches", "prefill_dispatches",
                  "syncs"):
            assert got[k] == want[k], k
    assert (fe.decode_dispatches(), fe.prefill_dispatches(),
            fe.sync_count(), fe.replicas_spawned, fe.failed_replicas) == (
        jfe.decode_dispatches(), jfe.prefill_dispatches(),
        jfe.sync_count(), jfe.replicas_spawned, jfe.failed_replicas)
    if out.get("mesh") is None:
        assert fe.prefill_retraces() == jfe.prefill_retraces()
    assert fe.ledger.balanced() and fe.ledger.balance() == \
        jfe.ledger.balance()
    assert fe.ledger.per_tier == jfe.ledger.per_tier
    if ref["pool"] is not None:
        assert out["pool"].summary() == ref["pool"].summary()
    if ref["sup"] is not None:
        assert out["sup"].plan_log == ref["sup"].plan_log
        assert out["sup"].summary() == ref["sup"].summary()


def _digest(fe):
    rows = sorted((r.rid, r.tier, tuple(r.output), r.arrival,
                   r.first_token_time, r.finish_time) for r in fe.finished)
    return hashlib.sha256(repr(rows).encode()).hexdigest(), len(rows)


LOOP = ["--device", "cpu", "--policy", "ours", "--autoscale", "gpso",
        "--ticks", str(TICKS)]
FAILURES = ["--seed", "1", "--failure-rate", "0.1", "--provision-delay", "1"]


@pytest.mark.parametrize("extra", [[], FAILURES],
                         ids=["defaults", "failures"])
def test_control_loop_matches_reference(models, extra):
    jm, jp, tm, tp = models
    args = serve.build_parser().parse_args(LOOP + extra)
    ref = cached_reference_loop(jm, jp, args)
    out = port_loop(tm, tp, args, ref)
    assert_loops_match(out, ref)
    assert len(out["ticks"]) == TICKS
    assert out["fe"].replicas_spawned > 2 * args.replicas  # GPSO scaled up


def test_cli_control_loop_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--policy", "ours", "--autoscale", "gpso", "--ticks", "10"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "balanced=True" in out.stdout and "plane host ms/tick" \
        in out.stdout
    assert "actor=fused" in out.stdout       # one launch an action


@pytest.mark.parametrize("flags", [["--devices", "2"],
                                   ["--mesh", "2:fleet", "--devices", "2"],
                                   ["--devices", "4"] + FAILURES])
def test_unported_control_flags_raise(models, flags, capsys):
    """--devices and --mesh are ported. The control loop over N virtual
    CPU shards, on the reference's weights, equals the reference's loop
    (streams, clocks, ledger, per-tick replicas, dispatches and syncs),
    with failures too; the CLI prints the mesh line and ends balanced and
    leaves the host device count as it found it."""
    jm, jp, tm, tp = models
    args = serve.build_parser().parse_args(LOOP + flags)
    ref = cached_reference_loop(jm, jp, args)
    out = port_loop(tm, tp, args, ref)
    assert_loops_match(out, ref)
    shards = 2 if "--mesh" in flags else int(flags[1])
    assert {g.shards for g in out["fe"]._fleets.values()} == {shards}
    before = mesh._host_devices
    serve.main(LOOP[:-1] + ["6"] + flags)
    text = capsys.readouterr().out
    assert f"[serve] mesh: {{'fleet': {shards}}} over {shards} device(s)" \
        in text
    assert "balanced=True" in text and "double_served=0" in text
    assert mesh._host_devices == before


def test_chunk_len_control_flag_runs(capsys):
    """--chunk-len is ported: the control loop streams long prompts in
    chunks and ends with a balanced ledger (its parity with the reference
    is tests/test_torch_chunked_prefill.py)."""
    serve.main(["--device", "cpu", "--policy", "ours", "--autoscale",
                "gpso", "--chunk-len", "4", "--max-seq", "64", "--ticks",
                "8"])
    out = capsys.readouterr().out
    assert "balanced=True" in out and "double_served=0" in out


def _control_args(*extra):
    return serve.build_parser().parse_args(
        ["--device", "cpu", "--policy", "ours", "--autoscale", "gpso",
         "--nodes", "2", "--replicas", "1", "--max-replicas", "4",
         "--provision-delay", "3", "--ticks", "40", "--rate", "2",
         "--max-batch", "8", "--max-seq", "256"] + list(extra))


@pytest.mark.parametrize("extra", [
    [], ["--seed", "2", "--failure-rate", "0.1"],
    ["--seed", "3", "--chaos", "preempt@8:n0:k3,recover@18:n0"]],
    ids=["defaults", "failures", "preempt"])
def test_async_tick_keeps_its_sync_contract(models, extra):
    """The flags of the full-width control loop on the card, at reduced
    width: every sync of the async tick consumes one fleet dispatch's
    results and each tick leaves its last round in flight; the eager
    oracle, which waits on every dispatch, breaks that contract."""
    _, _, tm, tp = models
    ticks = serve.run_control_loop(_control_args(*extra), tm.cfg, tm,
                                   tp)["ticks"]
    assert async_tick_violations(ticks) == []
    assert sum(t["in_flight_groups"] > 0 for t in ticks) > len(ticks) // 2
    eager = serve.run_control_loop(_control_args("--no-async", *extra),
                                   tm.cfg, tm, tp)["ticks"]
    assert async_tick_violations(eager)


def test_sync_contract_catches_a_wait_after_every_dispatch():
    """A tick that reconciles each dispatch as it is made pays the same
    total syncs but leaves nothing in flight: the contract refuses it."""
    tick = {"syncs": 2, "reconciles": 2, "decode_dispatches": 2,
            "last_round_dispatches": 2}
    deferred = [dict(tick, syncs=0, reconciles=0, in_flight_groups=2)] + \
        [dict(tick, in_flight_groups=2)] * 3
    assert async_tick_violations(deferred) == []
    waited = [dict(tick, in_flight_groups=0)] * 4
    assert len(async_tick_violations(waited)) == 4
    doubled = deferred[:1] + [dict(tick, syncs=4, reconciles=4,
                                   in_flight_groups=2)]
    assert async_tick_violations(doubled)
