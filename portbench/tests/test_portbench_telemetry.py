"""The readers of the program's own spans and counters
(``repro_torch.telemetry``) against the harness's work records, on a tiny
cell's ``loop.System`` on the CPU: the session of a ``tracing.Slice``
covers exactly its ticks, its prefill spans and prompt tokens are the
Recorder's prefill records, its stepped decode rows the Recorder's decode
records applied inside it; each new reader reads a finite value from it
and nothing without a trace; ``tools/span_totals.py``'s totals over a
run's window are the harness's window counters."""
import math

import pytest
import torch

from portbench import harness, loop, spec, tracing
from portbench.tests.conftest import ROOT
from portbench.tests.tiny import tiny_cell

CELLS = ("granite-3-8b.chat", "mamba2-1.3b.rag")
READERS = ("plane.gpso_ms_per_plan", "engine.prefill_pad_share.tail",
           "engine.prefill_pad_share.tput", "engine.decode_row_share")
TICK_S = 0.25                  # the traffic's seconds a tick hands out
SEED = 2**31 + 29


def _run(root, name, warm=4, traced=8, after=2):
    """``warm`` ticks, a CPU slice over ``traced`` more, ``after`` ticks
    with the profiler off; the Recorder installed throughout. Returns the
    slice, the recorder, the session and the decode records applied inside
    the slice."""
    from repro_torch import telemetry
    from repro_torch.models.model import make_model

    cell = tiny_cell(root, name)
    cfg, traffic = cell.config, cell.traffic
    dev = torch.device("cpu")
    model = make_model(harness.arch_config(cfg))
    weights = cell.reference().make_weights(cfg, SEED, dev, torch.float32)
    gen = cell.generator()
    ticks = warm + traced + after
    arrivals = gen.generate(traffic, SEED, [("window", 0.0, ticks * TICK_S)],
                            cfg["vocab_size"], rate=traffic["rate"],
                            anchor=0.0)
    system = loop.System(traffic["engine"], model, weights, torch.float32,
                         dev, SEED, gen.mean_length(traffic["output"]))
    recorder = tracing.Recorder(system)
    slicer = tracing.Slice(system, cuda=False)
    telemetry.session()                # close what an earlier run left open
    i = 0
    try:
        for t in range(ticks):
            if t == warm:
                slicer.start()
                first = len(recorder.records)
            if t == warm + traced:
                slicer.stop()
                last = len(recorder.records)
            due = []
            while i < len(arrivals) and arrivals[i].due < (t + 1) * TICK_S:
                due.append((arrivals[i], arrivals[i].due))
                i += 1
            system.step(due)
        session = telemetry.session()
        slicer.reduce()
    finally:
        recorder.remove()
    applied = [r for r in recorder.records[first:last] if r[0] == "decode"]
    return cell, slicer, recorder, session, applied


@pytest.fixture(scope="module", params=CELLS)
def traced(request):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield _run(ROOT, request.param)
    finally:
        torch.set_num_threads(n)


def test_session_is_the_slices_ticks(traced):
    cell, slicer, recorder, s, _ = traced
    assert slicer.end_tick - slicer.start_tick == 8
    assert s.spans["plane.step"][1] == slicer.end_tick - slicer.start_tick
    assert s.spans["frontend.tick"][1] == s.spans["plane.step"][1]


def test_prefill_counters_are_the_records(traced):
    cell, slicer, recorder, s, _ = traced
    pre = [r for r in recorder.in_ticks(slicer.start_tick, slicer.end_tick)
           if r[0] == "prefill"]
    assert pre
    assert s.spans["engine.fleet_prefill"][1] == len(pre)
    assert s.counters["engine.prefill_tokens"] == sum(sum(r[2]) for r in pre)
    assert s.counters["engine.prefill_slots"] \
        > s.counters["engine.prefill_tokens"]


def test_stepped_rows_are_the_records_applied(traced):
    cell, slicer, recorder, s, applied = traced
    assert applied
    assert s.counters["engine.decode_rows_stepped"] \
        == sum(len(r[2]) for r in applied)
    assert s.counters["engine.decode_rows_computed"] \
        >= s.counters["engine.decode_rows_stepped"]


@pytest.mark.parametrize("metric", READERS)
def test_readers_read_the_session(traced, metric):
    cell, slicer, recorder, s, _ = traced
    window = {"ticks": slicer.end_tick - slicer.start_tick}
    trace = dict(slicer.result, records=recorder.in_ticks(
        slicer.start_tick, slicer.end_tick))
    read = spec.metric_reader(cell.root, metric)
    v = read(harness.Ctx(cell.config, window, trace, cell.root))
    assert v is not None and math.isfinite(v) and v >= 0, v
    if metric.endswith("share") or "_share." in metric:
        assert v <= 100
    assert read(harness.Ctx(cell.config, window, None, cell.root)) is None


def _span_totals(root, name, trace):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tool = spec.load_module(root / "tools" / "span_totals.py",
                                "tools_span_totals")
        return tool.measure(tiny_cell(root, name), SEED, 1.5, trace,
                            device="cpu")
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
def test_span_totals_cover_the_window(root, name):
    # tools/span_totals.py reads the registry where the harness reads the
    # window's counters: its totals are the window's, tick for tick
    out = _span_totals(root, name, False)
    w, hw = out["window"], out["harness_window"]
    assert w["ticks"] == hw["ticks"] == out["info"]["window_ticks"] > 0
    sp = w["spans"]
    assert sp["frontend.tick"]["calls"] == w["ticks"]
    host = sum(sp[k]["ms_per_tick"] for k in (
        "plane.forecast", "plane.balance", "plane.learn", "plane.scale"))
    assert host * w["ticks"] / 1e3 == pytest.approx(hw["plane_host_s"])
    assert sp["engine.sync_wait"]["ms_per_tick"] * w["ticks"] / 1e3 \
        == pytest.approx(hw["sync_wait_s"])
    assert w["counters"]["engine.decode_rows_stepped"] \
        <= w["counters"]["engine.decode_rows_computed"]
    assert out["result"]["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_span_totals_split_a_traced_window(root, name):
    # traced, the window holds the profiled slice: the slice's session and
    # the rest of the window add up to the window, call for call
    out = _span_totals(root, name, True)
    w, s, rest = (out[k] for k in ("window", "session",
                                   "window_less_session"))
    assert 0 < s["ticks"] < w["ticks"]
    assert s["ticks"] + rest["ticks"] == w["ticks"]
    for k, v in w["spans"].items():
        parts = [p["spans"][k] for p in (s, rest) if k in p["spans"]]
        assert sum(p["calls"] for p in parts) == v["calls"], k
        assert sum(p["ms_per_call"] * p["calls"] for p in parts) \
            == pytest.approx(v["ms_per_call"] * v["calls"]), k
    for k, v in w["counters"].items():
        assert s["counters"].get(k, 0) + rest["counters"].get(k, 0) == v, k


def test_readers_read_nothing_without_a_session(root, monkeypatch):
    from repro_torch import telemetry

    monkeypatch.setattr(telemetry, "session",
                        lambda: telemetry.Session({}, {}))
    cell = tiny_cell(root, CELLS[0])
    trace = {"slice_s": 1.0, "busy_s": 0.5, "kernel_s": {}, "records": []}
    ctx = harness.Ctx(cell.config, {"ticks": 0}, trace, root)
    for metric in READERS:
        assert spec.metric_reader(root, metric)(ctx) is None, metric


def test_readers_read_nothing_from_a_program_without_spans(root,
                                                           monkeypatch):
    # the parent of this change has no ``repro_torch.telemetry``: its
    # traced runs leave the new metrics out
    import sys

    import repro_torch

    monkeypatch.delattr(repro_torch, "telemetry", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.telemetry", None)
    cell = tiny_cell(root, CELLS[0])
    trace = {"slice_s": 1.0, "busy_s": 0.5, "kernel_s": {}, "records": []}
    ctx = harness.Ctx(cell.config, {"ticks": 4}, trace, root)
    for metric in READERS:
        assert spec.metric_reader(root, metric)(ctx) is None, metric
