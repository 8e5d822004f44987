#!/usr/bin/env python3
"""Where the time of the GCN kernel goes, on one GPU.

    python3 tools/gcn_breakdown.py

Builds ``src/repro_torch/csrc/gcn_layer.cu`` once per variant in
``BUILDS`` (the default, and ``-DGCN_SKIP=bits`` builds that leave parts
of the action out: 1 the head's products, 2 the layers' products by W, 4
the products A_hat . h, 8 the copies of A_hat and the weights, 16 the
softmax) and times each, in turns (every variant, then every variant again in
reverse order): the balancer's whole action through ``ops.gcn_actor`` at
the serve defaults (2 nodes, F 12), the paper's cluster (16, F 36) and
graphs of 64 and 128 nodes, and one layer through ``ops.gcn_layer`` at the
balancer's shapes. A build with a part left out computes garbage: only its
time is read. The default build's largest error against the plain version
is printed. Then, with the default build, the layered chain the port ran
before (two ``gcn_layer`` launches, then the head, mask and softmax as
eager ops) and the plain version at the action's shapes, the launch floor
(one layer at N = F = H = 1), and the default build's SASS opcode counts
(its listing goes beside the builds, ``gcn_layer.sass``). Times are
CUDA-event medians over CUDA-graph replays, as in ``chip_smoke.py``. Needs
a Hopper card and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import collections
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "src" / "repro_torch" / "_build" / "breakdown"
# name -> -D flags: the source's default build and parts of it left out
BUILDS = {
    "default": {},
    "no head products": {"GCN_SKIP": 1},
    "no products by W": {"GCN_SKIP": 2},
    "no products A_hat . h": {"GCN_SKIP": 4},
    "no copies of A_hat and the weights": {"GCN_SKIP": 8},
    "no softmax": {"GCN_SKIP": 16},
    "copies, barriers and logits only": {"GCN_SKIP": 23},
    "X copy, barriers and logits only": {"GCN_SKIP": 31},
}
ACTIONS = ((2, 12), (16, 36), (64, 12), (128, 12))
LAYERS = ((2, 12, 64), (2, 64, 64), (16, 36, 64))
N_IN = 20


def _lib_path(flags: dict) -> Path:
    tag = "_".join(f"{k.lower()}{v}" for k, v in sorted(flags.items()))
    return OUT / f"libgcn_layer_{tag or 'default'}.so"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("gcn_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import _actor_inputs, _gcn_inputs, _graph_ms
    from repro_torch.core import ddpg
    from repro_torch.kernels import build, ops, ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    src = build.CSRC_DIR / "gcn_layer.cu"
    procs = {name: subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS,
         *(f"-D{k}={v}" for k, v in flags.items()), "-o",
         str(_lib_path(flags)), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in BUILDS.items()}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log, file=sys.stderr)
            return 1
        regs = re.findall(r"Used (\d+) registers", log)
        stack = re.findall(r"(\d+) bytes stack frame", log)
        print(f"[breakdown] {name}: registers {regs}, stack bytes {stack}",
              flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    actions = {s: _actor_inputs(torch, gen, *s) for s in ACTIONS}
    layers = {s: _gcn_inputs(torch, gen, s[:2], s[1:]) for s in LAYERS}
    times = collections.defaultdict(list)
    errs = collections.defaultdict(float)
    for name in list(BUILDS) + list(reversed(BUILDS)):
        # each build is its own library; the wrapper loads by name
        build._loaded["gcn_layer"] = ctypes.CDLL(str(_lib_path(BUILDS[name])))
        for s, (a, obs, gcn, head, up, _) in actions.items():
            times[name, "action", s].append(_graph_ms(torch, lambda: [
                ops.gcn_actor(a, obs, gcn, head, up_mask=up)
                for _ in range(N_IN)], N_IN))
            if not BUILDS[name]:
                got = ops.gcn_actor(a, obs, gcn, head, up_mask=up)
                want = ref.gcn_actor_ref(a, obs, gcn, head, up_mask=up)
                errs[name] = max(errs[name],
                                 (got - want).abs().max().item())
        for s, (a, x, w, b) in layers.items():
            times[name, "layer", s].append(_graph_ms(torch, lambda: [
                ops.gcn_layer(a, x, w, b) for _ in range(N_IN)], N_IN))
            got = ops.gcn_layer(a, x, w, b)
            errs[name] = max(errs[name], (got - ref.gcn_layer_ref(
                a, x, w, b)).abs().max().item())
    for name in BUILDS:
        err = f"{errs[name]:.3e}" if not BUILDS[name] \
            else "not computed (a part left out)"
        print(f"[breakdown] {name}: max|err| {err}", flush=True)
        for (what, shapes) in (("action", ACTIONS), ("layer", LAYERS)):
            for s in shapes:
                t = times[name, what, s]
                print(f"[breakdown]   {what} {s}: ms in turns "
                      f"{', '.join(f'{v:.4f}' for v in t)} (mean "
                      f"{statistics.mean(t):.4f})", flush=True)

    build._loaded["gcn_layer"] = ctypes.CDLL(str(_lib_path({})))
    for s, (a, obs, gcn, head, up, _) in actions.items():
        actor = {"gcn": gcn, "head": head}
        layered = _graph_ms(torch, lambda: [ddpg.actor_action(
            actor, a, obs, up_mask=up, fused=False) for _ in range(N_IN)],
            N_IN)
        plain = _graph_ms(torch, lambda: [ref.gcn_actor_ref(
            a, obs, gcn, head, up_mask=up) for _ in range(N_IN)], N_IN)
        print(f"[breakdown] action {s}: layered {layered:.4f} ms, plain "
              f"{plain:.4f} ms", flush=True)
    # the floor: the kernel at the smallest graph it takes (a zero
    # dimension is refused): 1 node, 1 feature, 1 unit
    a1, x1, w1, b1 = _gcn_inputs(torch, gen, (1, 1), (1, 1))
    floor = _graph_ms(torch, lambda: [ops.gcn_layer(a1, x1, w1, b1)
                                      for _ in range(N_IN)], N_IN)
    print(f"[breakdown] gcn_layer at N = F = H = 1 (the launch floor): "
          f"{floor:.4f} ms", flush=True)

    cuda_bin = Path(build.nvcc_path()).parent
    sass = subprocess.run([str(cuda_bin / "cuobjdump"), "-sass",
                           str(_lib_path({}))], capture_output=True,
                          text=True, check=True).stdout
    (OUT / "gcn_layer.sass").write_text(sass)
    counts = collections.Counter(
        m.group(1).split(".")[0] for m in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
            sass))
    print(f"[breakdown] SASS of gcn_kernel (default build): "
          f"{sum(counts.values())} instructions; " + ", ".join(
              f"{op} {c}" for op, c in counts.most_common(24)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
