"""Whole runs of the harness at a tiny size on the CPU (its look for a
card skipped): a sound run comes out correct; with the timed path broken
underneath (a token altered where it is produced; a decode step that
leaves its state unchanged) ``correct`` comes out false. And the entry
point refuses to run without a card, and outside a checkout."""
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness, run
from portbench.tests.tiny import tiny_cell

CELLS = ("granite-3-8b.chat", "mamba2-1.3b.rag")
SECONDS = 1.5


def _run(root, name, seed=2**31 + 11):
    cell = tiny_cell(root, name)
    return cell, harness.run(cell, seed, SECONDS, False, time.perf_counter(),
                             device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(root, one_thread, name):
    # other test files of this process may have loaded JAX: the run itself
    # must load none of it
    before = set(harness.banned_modules())
    cell, res = _run(root, name)
    assert set(res["banned"]) == before
    assert res["correct"], res["checks"]
    assert res["attempted"] == round(cell.traffic["rate"] * SECONDS)
    assert res["failed"] == 0
    assert res["checks"]["ledger_faults"]["value"] == 0
    line = harness.result_line(cell, res, False, "cpu")
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    json.dumps(line)


class _Composed(Exception):
    pass


@pytest.mark.parametrize("name", CELLS)
def test_system_seed_composes_the_system(root, one_thread, monkeypatch,
                                         name):
    # a traffic file's system_seed composes the system (the replicas' deal,
    # the plane's initial state) in every run, whatever the run's seed;
    # without one the run's seed does
    from portbench import loop

    seen = []

    def spy(engine, model, params, cache_dtype, device, seed, est_tokens):
        seen.append(seed)
        raise _Composed

    monkeypatch.setattr(loop, "System", spy)
    cell = tiny_cell(root, name)
    seeds = (5, 2**31 + 7)
    for s in seeds:
        with pytest.raises(_Composed):
            harness.run(cell, s, SECONDS, False, time.perf_counter(),
                        device="cpu")
    fixed = cell.traffic["engine"].get("system_seed")
    assert (fixed is not None) == (name == "granite-3-8b.chat")
    assert seen == ([fixed] * 2 if fixed is not None else list(seeds))


def test_overloaded_cell_stops_once_its_sample_is_in(root, one_thread,
                                                     monkeypatch):
    # rag reports no first-token tail: above its knee the run ends once
    # every counted request has entered and the sample is in, not when the
    # queue has given each its first token
    from portbench import check

    monkeypatch.setattr(check, "SAMPLE_TOKENS", 40)
    cell = tiny_cell(root, "mamba2-1.3b.rag")
    cell.traffic["rate"] = 128.0
    res = harness.run(cell, 9, SECONDS, False, time.perf_counter(),
                      device="cpu")
    info = res["info"]
    assert res["correct"], res["checks"]
    assert res["attempted"] == info["counted"] == round(128.0 * SECONDS)
    assert info["first_tokens"] < info["counted"]
    assert res["failed"] == 0
    assert info["wait_after_window_s"] < cell.traffic["drain_cap_s"]


def _alter_token(monkeypatch):
    from repro_torch.serving import engine

    core = engine.FleetGroup._fleet_core

    def altered(self, *a, **kw):
        nxt, done = core(self, *a, **kw)
        return (nxt + 1) % self.model.cfg.vocab_size, done
    monkeypatch.setattr(engine.FleetGroup, "_fleet_core", altered)


def _state_unchanged(monkeypatch, family):
    if family == "dense":
        from repro_torch.models import attention
        monkeypatch.setattr(attention, "write_kv",
                            lambda k, v, *a, **kw: (k, v))
    else:
        from repro_torch.models import ssd

        def frozen(state, x, dt, A, Bm, Cm, rows=None):
            return ssd._decode_step(state.clone(), x, dt, A, Bm, Cm,
                                    rows)[0], state
        monkeypatch.setattr(ssd, "ssd_decode_step", frozen)


@pytest.mark.parametrize("fault", ["token_altered", "state_unchanged"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_path_is_not_correct(root, one_thread, monkeypatch, name,
                                    fault):
    cell = tiny_cell(root, name)
    if fault == "token_altered":
        _alter_token(monkeypatch)
    else:
        _state_unchanged(monkeypatch, cell.config["family"])
    res = harness.run(cell, 5, SECONDS, False, time.perf_counter(),
                      device="cpu")
    assert not res["correct"]
    c = res["checks"]["served_gap"]
    assert c["value"] > c["limit"], res["checks"]


def test_no_card_no_result(root, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is there: the refusal shows only without one")
    rc = run.main(["--workload", "granite-3-8b.chat", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_outside_a_checkout_no_result(root, tmp_path):
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    shutil.copytree(root / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "granite-3-8b.chat", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
