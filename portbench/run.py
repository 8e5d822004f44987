#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one run of
one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload granite-3-8b.chat --seed 7 \
        --seconds 51 --trace 0

from the root of a checkout, on a machine with the CUDA devices the cell
asks for (exit code 3 and no result otherwise). With ``--trace 0`` the
last line of standard output is the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a profiled slice of the window;
the numbers compared for ``correct`` go to the last lines of standard
error and under ``checks`` in the result. Kernels build once into
``src/repro_torch/_build/`` inside the checkout (``repro_torch.kernels.
build``); the profiler's trace is written to the temporary directory and
deleted once read.
"""
import time

T_PROC0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"[portbench] {ROOT / 'src' / 'repro_torch'} is missing: the "
              "benchmark runs the port from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import harness

    return harness.main(sys.argv[1:] if argv is None else argv, ROOT,
                        T_PROC0)


if __name__ == "__main__":
    sys.exit(main())
