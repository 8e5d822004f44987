#!/usr/bin/env python3
"""Does a garbage-collection pass inside a CUDA-graph capture, freeing a
dead owner's graphs, break the capture? On one GPU.

    python3 tools/graph_gc_check.py

Three child processes, each capturing one decode-graph key
(``serving.graphs.DecodeGraphs``) while the only reference to another
owner's ten captured graphs (an object in a reference cycle) is dropped
inside the captured function, which then allocates with the collector's
thresholds at 1: "guarded" with ``DecodeGraphs``' own guard (the
collector off during the capture), "unguarded" with that guard made a
no-op, and "collect" with an explicit ``gc.collect()`` inside the capture
(what an automatic pass there does). Prints each child's outcome and its
stderr's tail (the CUDA graph warnings). Needs a CUDA card.
"""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHILD = r'''
import gc, sys, types
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.serving import graphs
mode = sys.argv[2]
if mode == "unguarded":
    graphs.gc = types.SimpleNamespace(isenabled=gc.isenabled,
                                      enable=gc.enable, disable=lambda: None)
dev = torch.device("cuda", 0)
x = torch.randn(256, 256, device=dev)


class Owner:
    pass


keep = []


def owner():
    o = Owner()
    o.graphs = graphs.DecodeGraphs(dev)
    o.me = o                              # a reference cycle
    for k in range(10):
        o.graphs.run(k, lambda: (x @ x,))
    keep.append(o)


owner()
g = graphs.DecodeGraphs(dev)
g.run("k", lambda: (x @ x,))              # the key's warm-up and capture
gc.collect()


def fn():
    keep.clear()                          # the owner dies inside the capture
    if mode == "collect":
        gc.collect()
    gc.set_threshold(1, 1, 1)             # the next allocation collects
    junk = [[i] for i in range(1000)]
    gc.set_threshold(700, 10, 10)
    return (x @ x + len(junk),)


try:
    g._graphs["k"] = g._record(fn)        # a capture with fn inside it
    out = g.run("k", fn)[0]
    torch.cuda.synchronize()
    print("capture ok", float(out[0, 0]))
except Exception as e:
    print("capture failed:", type(e).__name__, str(e).splitlines()[0])
'''


def main() -> int:
    for mode in ("guarded", "unguarded", "collect"):
        r = subprocess.run([sys.executable, "-c", CHILD, str(ROOT / "src"),
                            mode], capture_output=True, text=True,
                           timeout=300)
        print(mode, "->", r.stdout.strip(), "| stderr:",
              r.stderr.strip()[-400:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
