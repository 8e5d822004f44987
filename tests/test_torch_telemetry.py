"""The program's spans and counters (``repro_torch.telemetry``) on a tiny
control loop on the CPU: with the profiler off no ``record_function`` is
entered; under the profiler every span of the session is in the trace
with its count and about its seconds; a second session starts from zero;
the owners' own counters (``ControlPlane.host_s``, ``fetch_wait``, the
frontend's ``sync_wait_s()``) are exactly the spans' seconds."""
import collections
import contextlib
import itertools
import json
import statistics

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from repro_torch import telemetry
from repro_torch.configs import get_config
from repro_torch.control import ControlPlane
from repro_torch.core import balancer as bal
from repro_torch.launch.serve import build_parser, cluster_config
from repro_torch.models.model import make_model
from repro_torch.serving.elastic import ElasticClusterFrontend
from repro_torch.serving.engine import ReplicaEngine, Request

PLANE_KEYS = {"forecast": "plane.forecast", "balance": "plane.balance",
              "learn": "plane.learn", "scale": "plane.scale"}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def closed_session():
    """Close a session an earlier test left open: a session ends at the
    first span, count or ``session()`` that finds the profiler off, and a
    test may stop the profiler and run nothing of the program after."""
    telemetry.session()


@pytest.fixture(scope="module")
def model():
    m = make_model(get_config("granite-3-8b").reduced())
    return m, m.init(seed=0, device="cpu")


class Loop:
    """A tiny control loop as the benchmark composes it: two nodes of
    replicas at mixed speeds (sub-step rounds) and batch budgets, fleet
    batching and admission, the async tick with decode graphs, the
    GCN+DDPG balancer and GPSO; prompts up to 40 tokens, so prefills pad
    to several buckets."""

    def __init__(self, model, seed=0, rate=3.0):
        m, params = model
        args = build_parser().parse_args([
            "--policy", "ours", "--autoscale", "gpso", "--nodes", "2",
            "--replicas", "1", "--max-replicas", "2",
            "--provision-delay", "1", "--max-batch", "4", "--max-seq", "64",
            "--seed", str(seed), "--device", "cpu"])
        ccfg = cluster_config(args)
        mix = itertools.cycle([(0.7, 2), (1.0, 4), (1.4, 4), (1.0, 2)])
        rng = np.random.default_rng(seed)

        def make_replica(rid):
            speed, mb = next(mix)
            return ReplicaEngine(m, params, max_batch=mb, max_seq=64, rid=rid,
                                 speed=speed, device="cpu", decode_graph=True)

        def factory(rid, tick):
            n = int(rng.integers(3, 40))
            return Request(rid, rng.integers(1, 500, n).tolist(),
                           max_new_tokens=int(rng.integers(4, 12)))

        self.fe = ElasticClusterFrontend(
            make_replica, 2, initial_replicas=1, provisioning_delay=1,
            max_replicas_per_node=2, request_factory=factory, seed=seed,
            est_tokens=8.0, fleet_batch=True, fleet_prefill=True,
            async_tick=True)
        rl = bal.RLBalancer(ccfg, 4 + ccfg.horizon, seed=seed, device="cpu")
        self.plane = ControlPlane(ccfg, self.fe, balancer="rl",
                                  scaler="gpso", unit_capacity=0.5, rl=rl,
                                  seed=seed, device="cpu")
        self.rate = rate

    def run(self, ticks):
        for _ in range(ticks):
            self.plane.step(self.rate)

    def owners(self):
        return {"host_s": dict(self.plane.host_s),
                "fetch_wait": self.plane.fetch_wait,
                "sync_wait": self.fe.sync_wait_s()}


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _annotations(prof, tmp_path):
    """{name: [durations in s]} of the trace's user annotations, each
    name's in the order they end."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    out = collections.defaultdict(list)
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            out[e["name"]].append((e["ts"] + e["dur"], e["dur"] * 1e-6))
    return {k: [d for _, d in sorted(v)] for k, v in out.items()}


def _calls(monkeypatch):
    """{name: [seconds]} of each span call from now on, in the order the
    calls end; after each call an empty span ``t.calibrate`` runs, so that
    ``record_function``'s own cost is read in the state the program's
    spans leave the host in."""
    calls = collections.defaultdict(list)
    exit_ = telemetry._Span.__exit__
    calibrate = telemetry.span("t.calibrate")

    def timed(self, *exc):
        before = self.entry[0]
        out = exit_(self, *exc)
        calls[self.name].append(self.entry[0] - before)
        if self is not calibrate:
            with calibrate:
                pass
        return out

    monkeypatch.setattr(telemetry._Span, "__exit__", timed)
    return calls


def _profiled_run(model, tmp_path, monkeypatch):
    """12 profiled ticks after 4 of warm-up. Returns the session, the
    trace's annotations, each call's seconds and ``record_function``'s own
    cost a span: the 90th percentile of the empty spans' annotation less
    their seconds."""
    loop = Loop(model)
    loop.run(4)                      # replicas spawn, graphs are captured
    calls = _calls(monkeypatch)
    with _profile() as prof:
        loop.run(12)
    s = telemetry.session()
    trace = _annotations(prof, tmp_path)
    empty = [a - c for a, c in zip(trace["t.calibrate"],
                                   calls["t.calibrate"])]
    cost = statistics.quantiles(empty, n=10)[-1]
    return s, trace, calls, cost


def test_profiler_off_enters_no_record_function(model, one_thread,
                                                monkeypatch):
    entered = []
    enter = autograd_profiler.record_function.__enter__

    def counted(self):
        entered.append(self.name)
        return enter(self)

    monkeypatch.setattr(autograd_profiler.record_function, "__enter__",
                        counted)
    loop = Loop(model)
    before = telemetry._REG.snapshot()[0].get("plane.step", (0.0, 0))[1]
    loop.run(12)
    spans = telemetry._REG.snapshot()[0]
    assert entered == []
    assert spans["plane.step"][1] - before == 12
    for name in ("frontend.tick", "frontend.round", "engine.decode_round",
                 "engine.fleet_prefill", "plane.gpso_plan", "graphs.replay"):
        assert spans[name][1] > 0, name


def test_session_spans_are_in_the_trace(model, one_thread, tmp_path,
                                        monkeypatch):
    s, trace, calls, cost = _profiled_run(model, tmp_path, monkeypatch)
    assert s.spans["plane.step"][1] == 12
    for name in ("plane.forecast", "frontend.observe", "plane.balance",
                 "frontend.route", "plane.learn", "plane.scale",
                 "plane.gpso_plan", "frontend.scale_to", "plane.fetch",
                 "frontend.tick", "frontend.reconcile", "frontend.arrivals",
                 "frontend.round", "engine.admit_round",
                 "engine.fleet_prefill", "engine.decode_round",
                 "engine.stage_masks", "graphs.replay", "engine.reconcile",
                 "engine.sync_wait"):
        assert name in s.spans, name
    for name, (sec, n) in s.spans.items():
        assert len(trace[name]) == n, name
        # the span times the inside of its annotation
        assert sec <= sum(trace[name]) + n * 2e-6, name
    # which also holds part of record_function's own enter and exit
    # (``cost``): the whole tick, every span inside it, reads within 10%
    # of the trace, plus that cost a tick
    sec, n = s.spans["plane.step"]
    assert sum(trace["plane.step"]) <= 1.10 * sec + n * cost, cost
    c = s.counters
    assert 0 < c["engine.prefill_tokens"] < c["engine.prefill_slots"]
    assert 0 < c["engine.decode_rows_stepped"] \
        <= c["engine.decode_rows_computed"]


def test_each_call_sits_inside_its_annotation(model, one_thread, tmp_path,
                                              monkeypatch):
    # call by call (a name's calls and annotations paired in the order
    # they end): every call's seconds lie inside its annotation, and in
    # its closest call the annotation exceeds them by no more than 10% and
    # record_function's cost. A span that left out a part of its body
    # would show in every call; a host slowed or descheduled inside
    # record_function (a loaded machine) shows in some calls only, so a
    # span of one or two calls (a capture, a GPSO plan) is held to the
    # first check alone
    s, trace, calls, cost = _profiled_run(model, tmp_path, monkeypatch)
    checked = 0
    for name, (sec, n) in s.spans.items():
        got = calls[name][-n:]
        assert sum(got) == pytest.approx(sec, rel=1e-9, abs=1e-12), name
        excess = [a - c for a, c in zip(trace[name], got)]
        assert min(excess) >= -2e-6, name
        if n >= 3:
            checked += 1
            assert min(x - 0.10 * c for x, c in zip(excess, got)) \
                <= cost, (name, cost, sorted(excess))
    assert checked >= 15


def test_a_second_session_starts_from_zero(model, one_thread):
    loop = Loop(model)
    with _profile():
        loop.run(5)
    first = telemetry.session()
    loop.run(2)                       # profiler off: closes the session
    assert telemetry.session() == first
    with _profile():
        loop.run(3)
    second = telemetry.session()
    assert first.spans["plane.step"][1] == 5
    assert second.spans["plane.step"][1] == 3
    assert second.counters["engine.decode_rows_computed"] \
        < first.counters["engine.decode_rows_computed"] \
        + second.counters["engine.decode_rows_computed"]
    # a profiler session that runs no program code opens none
    with _profile():
        torch.zeros(2).add_(1)
    assert telemetry.session() == second


def test_owner_counters_are_the_spans_seconds(model, one_thread):
    loop = Loop(model)
    loop.run(3)
    a = loop.owners()
    with _profile():
        loop.run(8)
    b = loop.owners()
    s = telemetry.session().spans
    for key, name in PLANE_KEYS.items():
        assert b["host_s"][key] - a["host_s"][key] == pytest.approx(
            s[name][0], rel=1e-9, abs=1e-12), key
    assert sum(b["host_s"].values()) - sum(a["host_s"].values()) \
        == pytest.approx(sum(s[n][0] for n in PLANE_KEYS.values()),
                         rel=1e-9, abs=1e-12)
    assert b["fetch_wait"] - a["fetch_wait"] == pytest.approx(
        s["plane.fetch"][0], rel=1e-9, abs=1e-12)
    assert b["sync_wait"] - a["sync_wait"] == pytest.approx(
        s["engine.sync_wait"][0], rel=1e-9, abs=1e-12)


class _Owner:
    wait = 0.0


def test_span_adds_into_its_owner_and_registry():
    owner, host = _Owner(), {"k": 1.0}
    before = telemetry._REG.snapshot()[0].get("t.outer", (0.0, 0))
    with telemetry.span("t.outer", into=(host, "k")) as outer:
        with telemetry.span("t.inner", into=(owner, "wait")):
            pass
    after = telemetry._REG.snapshot()[0]["t.outer"]
    assert after[1] == before[1] + 1
    assert host["k"] - 1.0 == pytest.approx(after[0] - before[0])
    assert 0.0 < owner.wait <= host["k"] - 1.0
    assert outer.open == []           # every entry closed


def test_a_plain_span_is_one_object_a_name():
    assert telemetry.span("t.plain") is telemetry.span("t.plain")
    owner = _Owner()
    fed = telemetry.span("t.plain", into=(owner, "wait"))
    assert fed is not telemetry.span("t.plain")
    assert fed.entry is telemetry.span("t.plain").entry


def test_count_opens_a_session_and_sums():
    with _profile():
        telemetry.count("t.count", 3)
        telemetry.count("t.count", 4)
    s = telemetry.session()
    assert s.counters == {"t.count": 7}
    assert s.spans == {}


def test_spanned_keeps_the_function():
    @telemetry.spanned("t.spanned")
    def f(a, b=2):
        """doc"""
        return a + b

    assert f.__name__ == "f" and f.__doc__ == "doc"
    before = telemetry._REG.snapshot()[0].get("t.spanned", (0.0, 0))[1]
    assert f(1, b=3) == 4
    assert telemetry._REG.snapshot()[0]["t.spanned"][1] == before + 1


def test_a_span_nests_in_itself():
    s = telemetry.span("t.nested")
    before = tuple(s.entry)
    with telemetry.span("t.nested"):
        t = telemetry._clock()
        with telemetry.span("t.nested"):
            pass
        inner = telemetry._clock() - t
    assert s.entry[1] == before[1] + 2
    assert s.entry[0] - before[0] >= inner
    assert s.open == []


@pytest.mark.parametrize("profiled", [False, True], ids=["off", "profiled"])
def test_a_span_that_raises_still_counts_and_closes(profiled):
    s = telemetry.span("t.raises")
    before = tuple(s.entry)
    with _profile() if profiled else contextlib.nullcontext():
        with pytest.raises(ValueError):
            with telemetry.span("t.raises"):
                raise ValueError("inside the span")
    assert s.entry[1] == before[1] + 1
    assert s.entry[0] > before[0]
    assert s.open == []
    if profiled:
        assert telemetry.session().spans["t.raises"][1] == 1
