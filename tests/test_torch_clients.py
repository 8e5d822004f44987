"""The port's closed-loop clients (``workload.clients.ClientPool``) against
the reference's, in one process, on reduced granite-3-8b with the
reference's weights bridged.

Mirrors ``tests/test_chaos_clients.py``'s client-pool case (the spawn-rate
ramp, the per-tier client stats, the ledger's balance): both packages run
the same clients over the same requests, and the ramp, the client summary,
the ledger and the streams must be equal. ``--clients`` through
``run_control_loop`` (per-tier timeouts, retries, a ramp, spot
preemption) is held to the reference's too; ``--timeout`` parses as the
reference parses it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.launch.serve import _parse_timeout as jax_parse_timeout
from repro.models import make_model as jax_make_model
from repro.serving import ElasticClusterFrontend as JaxElastic
from repro.serving import ReplicaEngine as JaxReplica
from repro.serving import Request as JaxRequest
from repro.workload import ClientPool as JaxPool
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models.model import make_model
from repro_torch.serving.elastic import ElasticClusterFrontend
from repro_torch.serving.engine import ReplicaEngine, Request
from repro_torch.workload.clients import ClientPool
from test_torch_control_loop import (assert_loops_match,
                                     cached_reference_loop, port_loop)
from test_torch_vlm import _one_torch_thread  # noqa: F401

MAX_SEQ = 64


@pytest.fixture(scope="module")
def models():
    jm = jax_make_model(jax_get_config("granite-3-8b").reduced(), tp=1)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    tm = make_model(get_config("granite-3-8b").reduced(), tp=1)
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _pool_run(side, models, tiers_split=False):
    jm, jp, tm, tp = models
    req_cls = JaxRequest if side == "jax" else Request

    def request_factory(rid, tick):
        r = req_cls(rid, [1 + (rid + j) % 97 for j in range(3)],
                    max_new_tokens=4)
        if tiers_split:
            r.tier = "premium" if rid % 3 == 0 else "standard"
        return r

    if side == "jax":
        fe = JaxElastic(lambda rid: JaxReplica(jm, jp, max_batch=2,
                                               max_seq=MAX_SEQ, rid=rid),
                        1, initial_replicas=2)
        pool_cls = JaxPool
    else:
        fe = ElasticClusterFrontend(
            lambda rid: ReplicaEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ,
                                      rid=rid, device="cpu"),
            1, initial_replicas=2)
        pool_cls = ClientPool
    timeout = {"premium": 3.0, "default": 20.0} if tiers_split else 20.0
    pool = pool_cls(fe, 10, request_factory=request_factory,
                    think_time=1.0, timeout=timeout, max_retries=1,
                    spawn_rate=4.0, seed=2)
    ramp = []
    for _ in range(20):
        pool.tick()
        ramp.append(pool.active_clients)
        fe.tick(0.0)
    pool.quiesce()
    fe.run_until_drained()
    pool.finalize()
    stream = sorted((r.rid, r.tier, tuple(r.output), r.first_token_time,
                     r.finish_time) for r in fe.finished)
    return ramp, pool.summary(), fe.ledger.balance(), fe.ledger.per_tier, \
        stream


@pytest.mark.parametrize("tiers_split", [False, True],
                         ids=["one-tier", "per-tier-timeouts"])
def test_client_pool_flash_ramp_and_stats(models, tiers_split):
    got = _pool_run("torch", models, tiers_split)
    assert got == _pool_run("jax", models, tiers_split)
    ramp, s, bal, _, _ = got
    assert ramp[:3] == [4, 8, 10]                    # the spawn ramp
    assert s["ok"] > 0 and s["latency_mean"] is not None
    assert bal["live"] == 0 and bal["double_served"] == 0
    assert bal["submitted"] == s["ok"] + s["abandoned"]
    assert s["issued"] >= bal["submitted"]
    if tiers_split:
        assert s["per_tier"]["premium"]["timed_out"] + \
            s["per_tier"]["premium"]["ok"] > 0


@pytest.mark.parametrize("spec", ["8", "2.5", "premium:4,batch:16,default:8",
                                  " premium:4 , default:9 "])
def test_parse_timeout_matches_reference(spec):
    assert serve._parse_timeout(spec) == jax_parse_timeout(spec)


def test_parse_timeout_refuses_what_the_reference_refuses():
    for parse in (serve._parse_timeout, jax_parse_timeout):
        with pytest.raises(ValueError, match="bad timeout"):
            parse("premium")


CLIENT_LOOP = ["--device", "cpu", "--policy", "ours", "--autoscale", "gpso",
               "--ticks", "15", "--clients", "16", "--timeout",
               "premium:5,default:9", "--retries", "2", "--spawn-rate", "4",
               "--tiers", "premium:0.3:w5:4,standard:0.7:w1",
               "--chaos", "preempt@6:n0:k3,recover@12:n0"]


def test_control_loop_clients_matches_reference(models):
    """``--clients`` through ``run_control_loop``: the clients replace the
    trace; streams, finish clocks, ledger terminals per tier, per-tick
    counts and the clients' report equal the reference's."""
    jm, jp, tm, tp = models
    args = serve.build_parser().parse_args(CLIENT_LOOP)
    ref = cached_reference_loop(jm, jp, args)
    out = port_loop(tm, tp, args, ref)
    assert_loops_match(out, ref)
    s = out["pool"].summary()
    assert s["clients"] == 16 and s["issued"] > 0
    assert out["fe"].ledger.balanced() and out["fe"].preempted_nodes == 1


def test_control_loop_tiers_sharded_matches_reference(models):
    """The SLO tiers, the clients and a node preemption of the loop above
    over 4 virtual shards (``--devices 4``): the reference's loop, tier
    by tier and tick by tick."""
    jm, jp, tm, tp = models
    args = serve.build_parser().parse_args(CLIENT_LOOP + ["--devices", "4"])
    ref = cached_reference_loop(jm, jp, args)
    out = port_loop(tm, tp, args, ref)
    assert_loops_match(out, ref)
    assert out["fe"].preempted_nodes == 1
