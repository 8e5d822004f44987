#!/usr/bin/env python3
"""Where the time of the bf16 flash_attention kernel goes, on one GPU.

    python3 tools/attention_breakdown.py

Builds ``src/repro_torch/csrc/flash_attention.cu`` several times with
``-DFA_SKIP=bits``, each build leaving parts of the tile loop out (bit 1:
the K/V loads past the first tile, bit 2: the two products, bit 4: the
softmax), and times each build at the drain bucket (8 prompts x 512) for
granite-3-8b's head layout (8 kv x 4 q heads, hd 128) and zamba2-2.7b's
shared block (32 x 1, hd 80), beside the whole kernel and SDPA. A build
with a part left out computes garbage; only its time is read. Times are
CUDA-event medians over CUDA-graph replays, as in ``chip_smoke.py``. Needs
a Hopper card and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "src" / "repro_torch" / "_build" / "breakdown"
# FA_SKIP bits -> what the build keeps
BUILDS = {0: "whole kernel", 1: "products + softmax", 2: "loads + softmax",
          4: "loads + products", 6: "loads only", 5: "products only",
          3: "softmax only"}
LAYOUTS = (("granite-3-8b", 8, 4, 128), ("zamba2-2.7b", 32, 1, 80))
B, S = 8, 512


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("attention_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    from chip_smoke import _graph_ms
    from repro_torch.kernels import build, ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    src = build.CSRC_DIR / "flash_attention.cu"
    procs = {bits: subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, f"-DFA_SKIP={bits}", "-o",
         str(OUT / f"libflash_attention_skip{bits}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for bits in BUILDS}
    for bits, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log, file=sys.stderr)
            return 1

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    n = 10
    for name, G, qpg, hd in LAYOUTS:
        q = torch.randn(B, S, G, qpg, hd, generator=gen,
                        device="cuda").to(bf)
        k = torch.randn(B, S, G, hd, generator=gen, device="cuda").to(bf)
        v = torch.randn(B, S, G, hd, generator=gen, device="cuda").to(bf)
        q4 = q.reshape(B, S, G * qpg, hd).transpose(1, 2)
        sdpa = _graph_ms(torch, lambda: [F.scaled_dot_product_attention(
            q4, k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
            enable_gqa=True) for _ in range(n)], n)
        print(f"[breakdown] {name} B={B} S={S} Hq={G * qpg} Hkv={G} hd={hd} "
              f"causal bf16: sdpa {sdpa:.4f} ms", flush=True)
        for bits, what in BUILDS.items():
            # each build is its own library; the wrapper loads by name
            build._loaded["flash_attention"] = ctypes.CDLL(
                str(OUT / f"libflash_attention_skip{bits}.so"))
            ms = _graph_ms(torch, lambda: [ops.flash_attention(q, k, v)
                                           for _ in range(n)], n)
            print(f"[breakdown] {name} FA_SKIP={bits} ({what}): {ms:.4f} ms",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
