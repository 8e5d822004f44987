"""On the card, at each cell's own size and load: the control, the plain
reference computed in float8 (the step below the served bfloat16), has to
come out as not correct, while the program's own run does; three seeds a
cell. The harness's runs never run it. A short window at the cell's load
finishes its longest requests and compares as many tokens as a run.

    python -m pytest -q -m chip portbench/tests/test_portbench_control.py
"""
import time

import pytest

from portbench import harness, spec

CELLS = ("granite-3-8b.chat", "mamba2-1.3b.rag")
SEEDS = (3_000_000_001, 3_000_000_002, 3_000_000_003)


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(card, root, name):
    cell = spec.load_cell(root, name)
    limit = cell.config["limits"]["served_gap"]
    for seed in SEEDS:
        res = harness.run(cell, seed, 15.0, False, time.perf_counter(),
                          control=True)
        assert res["correct"], (seed, res["checks"])
        assert res["control"] > limit, (seed, res["control"], limit)
