#!/usr/bin/env python3
"""Where the time of the ssd_scan kernel goes, on one GPU.

    python3 tools/ssd_breakdown.py

Builds ``src/repro_torch/csrc/ssd_scan.cu`` once per variant in
``BUILDS`` (``-DSSD_SKIP=bits`` leaves parts of the block loop out,
``-DSSD_SPLIT=k`` picks how operands are split into TF32 hi and lo; see
the source) and times each at mamba2-1.3b's and zamba2-2.7b's heads, at
the drain bucket (8 prompts x 512) and the control loop's largest fleet
prefill (4 x 16). A build with a part left out computes garbage; only its
time is read, and the other variants' largest error against the plain
version is printed. Then the whole kernel at every (tile, heads a block),
forced past ``ssd_scan.plan``, at the same shapes; and an opcode count of
one instantiation's SASS (``cuobjdump``). Times are CUDA-event medians over
CUDA-graph replays, as in ``chip_smoke.py``. Needs a Hopper card and
``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import collections
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "src" / "repro_torch" / "_build" / "breakdown"
# name -> -D flags; variants of the source's default design
BUILDS = {
    "whole kernel": {},
    "split by cvt.rna.tf32.f32": {"SSD_SPLIT": 1},
    "lo left to the tensor core's truncation": {"SSD_SPLIT": 2},
    "one TF32 pass": {"SSD_SKIP": 16},
    "no state term of y": {"SSD_SKIP": 1},
    "no diagonal term": {"SSD_SKIP": 2},
    "no state update": {"SSD_SKIP": 4},
    "no C.B^T": {"SSD_SKIP": 8},
    "loads, scan and stores only": {"SSD_SKIP": 15},
}
SHAPES = ((8, 512), (4, 16))
ARCHS = (("mamba2-1.3b", 64, 64, 128), ("zamba2-2.7b", 80, 64, 64))
SASS_KERNEL = "ssd_scan_kernelILi32ELi2ELi16E"


def _lib_path(flags: dict) -> Path:
    tag = "_".join(f"{k.lower()}{v}" for k, v in sorted(flags.items()))
    return OUT / f"libssd_scan_{tag or 'default'}.so"


def _opcodes(lib: Path, cuda_bin: Path) -> collections.Counter:
    """Opcode counts of one instantiation's SASS in ``lib``."""
    sass = subprocess.run([str(cuda_bin / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts, inside = collections.Counter(), False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = SASS_KERNEL in line
        elif inside:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)", line)
            if m:
                counts[m.group(1).split(".")[0]] += 1
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import _graph_ms, _ssd_inputs
    from repro_torch.kernels import build, ops, ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    src = build.CSRC_DIR / "ssd_scan.cu"
    variants = {str(_lib_path(f)): f for f in BUILDS.values()}
    procs = {path: subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS,
         *(f"-D{k}={v}" for k, v in flags.items()), "-o", path, str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for path, flags in variants.items()}
    for path, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log, file=sys.stderr)
            return 1
        regs = re.findall(r"Used (\d+) registers", log)
        stack = re.findall(r"(\d+) bytes stack frame", log)
        print(f"[breakdown] {variants[path] or 'default'}: registers {regs}, "
              f"stack bytes {stack}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, H, P, N in ARCHS:
        for B, T in SHAPES:
            x, a, bm, cm = _ssd_inputs(torch, gen, B, T, H, P, N)
            y_ref, s_ref = ref.ssd_scan_ref(x, a, bm, cm, min(256, T))
            n = 10 if B * T <= 1024 else 3
            for what, flags in BUILDS.items():
                # each build is its own library; the wrapper loads by name
                build._loaded["ssd_scan"] = ctypes.CDLL(str(_lib_path(flags)))
                ms = _graph_ms(torch, lambda: [
                    ops.ssd_scan(x, a, bm, cm, chunk=min(256, T))
                    for _ in range(n)], n)
                err = ""
                if flags.get("SSD_SKIP", 0) in (0, 16):
                    y, s = ops.ssd_scan(x, a, bm, cm, chunk=min(256, T))
                    err = (f", max|err| y {(y - y_ref).abs().max().item():.3e}"
                           f" state {(s - s_ref).abs().max().item():.3e}")
                print(f"[breakdown] {name} B={B} T={T} H={H} P={P} N={N}: "
                      f"{what} {ms:.4f} ms{err}", flush=True)

    # the whole kernel at every (tile, hpb), forced past ``plan``
    from repro_torch.kernels import ssd_scan as ssd
    build._loaded["ssd_scan"] = ctypes.CDLL(str(_lib_path({})))
    lib = ssd._lib()
    for name, H, P, N in ARCHS:
        for B, T in SHAPES:
            x, a, bm, cm = _ssd_inputs(torch, gen, B, T, H, P, N)
            y = torch.empty_like(x)
            st = torch.empty((B, H, P, N), device="cuda")
            n = 10 if B * T <= 1024 else 3
            for tile in ssd.TILES:
                for hpb in range(1, ssd.MAX_HPB + 1):
                    def run():
                        for _ in range(n):
                            lib.ssd_scan_launch(
                                x.data_ptr(), a.data_ptr(), bm.data_ptr(),
                                cm.data_ptr(), None, y.data_ptr(),
                                st.data_ptr(),
                                B, T, H, P, N, tile, hpb,
                                torch.cuda.current_stream().cuda_stream)
                    ms = _graph_ms(torch, run, n)
                    print(f"[breakdown] {name} B={B} T={T}: tile {tile} hpb "
                          f"{hpb} {ms:.4f} ms (smem "
                          f"{ssd.smem_bytes(tile, hpb, N)} B; plan "
                          f"{ssd.device_plan(B, T, H, N, 'cuda')})",
                          flush=True)

    cuda_bin = Path(build.nvcc_path()).parent
    ops_count = _opcodes(_lib_path({}), cuda_bin)
    total = sum(ops_count.values())
    print(f"[breakdown] SASS of ssd_scan_kernel<32, 2, 16> (whole kernel): "
          f"{total} instructions; " + ", ".join(
              f"{op} {c}" for op, c in ops_count.most_common(16)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
