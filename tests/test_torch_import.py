"""The port stands alone: importing every module of ``repro_torch`` pulls in
neither ``jax`` nor any module of the JAX package ``repro``, and no source
of the port (nor ``chip_smoke.py``) has an import of either."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(from|import)\s+(jax|repro)(\.|\s|$)", re.M)

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(" ".join(names))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_import_pulls_in_no_jax_and_no_repro():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    imported = set(out.stdout.splitlines()[0].split())
    # every module file of the package was imported by the probe
    on_disk = {"repro_torch." + ".".join(p.relative_to(PORT).with_suffix("")
                                         .parts).replace(".__init__", "")
               for p in PORT.rglob("*.py") if p.name != "__init__.py"
               or p.parent != PORT}
    assert on_disk <= imported, sorted(on_disk - imported)
    assert {"repro_torch.core.gpso", "repro_torch.control.plane",
            "repro_torch.serving.elastic",
            "repro_torch.kernels.gcn_fused"} <= imported


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_jax_or_repro_import(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path}: {hits}"
