"""Finds what a cell needs by name: its entry in ``BENCHMARK.json``, the
configuration file, the traffic file and its generator, the per-layer
metric readers, the kernels' work counts and the family's reference.

Each lives in a file of its own under ``portbench/`` (``configs/``,
``traffic/<name>.json`` with ``traffic/gen_<kind>.py``,
``metrics/<metric>.py``, ``counts/<kernel>.py``,
``reference/<family>.py``), so a new cell, traffic mix, metric, kernel
or family is a new file and new entries, and no edit of a file that is
there."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_module(path: Path, name: str):
    """The module in ``path``, loaded under ``name`` (a file's name may
    hold dots, as a metric's does)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    mod = sys.modules.get(name)
    if mod is not None and getattr(mod, "__file__", None) == str(path):
        return mod
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic file's contents
    traffic_name: str
    end_to_end: list      # the end-to-end metric entries this cell reports
    per_layer: list       # the per-layer metric entries this cell reports
    root: Path

    def generator(self):
        kind = self.traffic["kind"]
        return load_module(self.root / "portbench" / "traffic"
                           / f"gen_{kind}.py", f"portbench_gen_{kind}")

    def reference(self):
        fam = self.config["family"]
        return load_module(self.root / "portbench" / "reference"
                           / f"{fam}.py", f"portbench_ref_{fam}")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
    return Cell(name, int(w["chips"]), cfg, traffic, w["traffic"],
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)], root)


def metric_reader(root: Path, name: str):
    """``read(ctx)`` of the per-layer metric ``name``."""
    return load_module(root / "portbench" / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_")).read


def kernel_counts(root: Path, kernel: str):
    """The module with ``work(...) -> (flops, bytes)`` of ``kernel``."""
    return load_module(root / "portbench" / "counts" / f"{kernel}.py",
                       f"portbench_counts_{kernel}")
