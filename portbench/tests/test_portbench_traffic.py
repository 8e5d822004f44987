"""The open-loop generator: a seed fixes the schedule; every seed gets
the same counts, lengths and gaps in another order; the on/off schedule
keeps the mean rate; the harness finds a new traffic file and cell by
name."""
import collections
import json
import shutil

import numpy as np
import pytest

from portbench import spec
from portbench.traffic import gen_openloop as gen

CHAT = {"kind": "openloop", "rate": 4.0,
        "prompt": {"dist": "lognormal", "median": 256, "sigma": 0.8,
                   "min": 16, "max": 768},
        "output": {"dist": "uniform", "min": 16, "max": 48}}
BLOCKS = [("warm", 0.0, 5.0), ("window", 5.0, 45.0), ("tail", 45.0, 60.0)]


def _key(a):
    return (round(a.due, 9), tuple(a.prompt), a.max_new_tokens, a.block)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_same_seed_same_schedule(seed):
    a = gen.generate(CHAT, seed, BLOCKS, 1000)
    b = gen.generate(CHAT, seed, BLOCKS, 1000)
    assert [_key(x) for x in a] == [_key(x) for x in b]
    assert all(x.due <= y.due for x, y in zip(a, a[1:]))
    assert all(1 <= t < 1000 for x in a for t in x.prompt)


def test_seeds_share_the_work():
    a = gen.generate(CHAT, 1, BLOCKS, 1000)
    b = gen.generate(CHAT, 2, BLOCKS, 1000)
    for name, lo, hi in BLOCKS:
        xa = [x for x in a if x.block == name]
        xb = [x for x in b if x.block == name]
        assert len(xa) == len(xb) == round(CHAT["rate"] * (hi - lo))
        assert all(lo <= x.due < hi for x in xa)
        assert sorted(len(x.prompt) for x in xa) == \
            sorted(len(x.prompt) for x in xb)
        assert sorted(x.max_new_tokens for x in xa) == \
            sorted(x.max_new_tokens for x in xb)
    assert [_key(x) for x in a] != [_key(x) for x in b]


def test_lengths_follow_their_distribution():
    q = gen.quantiles(CHAT["prompt"], 1001)
    assert q.min() >= 16 and q.max() <= 768
    assert q[500] == 256                           # the median
    u = gen.quantiles({"dist": "uniform", "min": 16, "max": 48}, 3300)
    assert u.min() == 16 and u.max() == 48
    assert set(collections.Counter(u.tolist()).values()) == {100}


def test_burst_mean_is_the_mean_rate():
    burst = dict(CHAT, schedule={"kind": "onoff", "cycle_s": 10.0,
                                 "on_s": 3.0, "on_factor": 2.0,
                                 "off_factor": 4.0 / 7.0})
    arr = gen.generate(burst, 3, [("window", 0.0, 40.0)], 1000)
    assert len(arr) == 4 * 40
    dues = np.array([x.due for x in arr])
    on = ((dues % 10.0) < 3.0).sum()
    assert on == 4 * 24                    # 3 s at 8 req/s a cycle
    assert len(arr) - on == 4 * 16         # 7 s at 16/7 req/s
    assert gen.rate_at(burst["schedule"], 4.0, 12.5, 10.0) == 8.0
    assert gen.rate_at(burst["schedule"], 4.0, 14.0, 10.0) == \
        pytest.approx(16 / 7)


def test_new_traffic_and_cell_found_by_name(root, tmp_path):
    (tmp_path / "portbench").mkdir()
    for d in ("configs", "traffic"):
        shutil.copytree(root / "portbench" / d, tmp_path / "portbench" / d)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    new = dict(json.loads((root / "portbench/traffic/chat.json").read_text()),
               rate=1.5)
    new["prompt"] = dict(new["prompt"], median=600, min=400, max=900)
    (tmp_path / "portbench/traffic/longchat.json").write_text(json.dumps(new))
    bench["workloads"].append({"name": "granite-3-8b.longchat",
                               "config": "granite-3-8b",
                               "traffic": "longchat", "chips": 1,
                               "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell(tmp_path, "granite-3-8b.longchat")
    assert cell.traffic_name == "longchat" and cell.traffic["rate"] == 1.5
    assert cell.config["name"] == "granite-3-8b"
    assert {m["name"] for m in cell.end_to_end} == {"setup_s"}
    arr = cell.generator().generate(cell.traffic, 5, [("window", 0.0, 20.0)],
                                    cell.config["vocab_size"])
    assert len(arr) == 30 and all(400 <= len(a.prompt) <= 900 for a in arr)
    with pytest.raises(KeyError):
        spec.load_cell(tmp_path, "granite-3-8b.nothing")
