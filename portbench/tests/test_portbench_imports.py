"""Nothing under portbench/ imports JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` passes, ``repro``
fails), and the references import nothing of the program."""
import ast
from pathlib import Path

import pytest

from portbench import harness

BENCH = Path(__file__).resolve().parents[1]


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_whole_name_rule():
    assert harness.BANNED == ("jax", "jaxlib", "flax", "repro")
    for ok in ("repro_torch", "repro_torch.serving", "reprox"):
        assert ok.split(".")[0] not in harness.BANNED
    for bad in ("repro", "repro.models", "jax.numpy", "flax"):
        assert bad.split(".")[0] in harness.BANNED


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_no_reference_package(path):
    names = top_level_imports(path)
    assert not names & set(harness.BANNED), (path, names)
    if path.parent.name == "reference":
        assert "repro_torch" not in names, path


def test_banned_modules_reads_sys_modules(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "repro_torch_fake", types.ModuleType("x"))
    assert harness.banned_modules() == [m for m in harness.banned_modules()
                                        if m.split(".")[0] != "repro_torch"]
    monkeypatch.setitem(sys.modules, "repro.fake", types.ModuleType("y"))
    assert "repro.fake" in harness.banned_modules()
