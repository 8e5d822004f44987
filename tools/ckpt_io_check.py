#!/usr/bin/env python3
"""How long a sharded checkpoint of a given size takes to save and
restore on one GPU.

    python3 tools/ckpt_io_check.py [ROWS]

On a one-rank NCCL (data 1, model 1) ``DeviceMesh``: twelve f32 DTensor
leaves of (ROWS, 4096) (default 61,035: 12.0 GB, granite-3-8b's train
state at 4 layers, params and two moments) and one small bf16 leaf,
saved by ``checkpoint.save_checkpoint`` into a temporary directory and
restored by ``restore_latest``. Prints the disk and host memory the
machine has, the save's and the restore's host ms (the restore reads
from a warm page cache), the checkpoint's bytes, whether every leaf came
back equal, and the card's name and power limit. Exits non-zero when a
leaf differs. Needs a CUDA card; imports nothing of JAX.
"""
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.checkpoint.manager import restore_latest, save_checkpoint
    from repro_torch.launch.mesh import make_device_mesh

    if not torch.cuda.is_available():
        print("ckpt_io_check: no CUDA card", file=sys.stderr)
        return 1
    rows = int(sys.argv[1]) if len(sys.argv) > 1 else 61035
    print(subprocess.run(["df", "-h", ".", tempfile.gettempdir()],
                         capture_output=True, text=True).stdout)
    print(subprocess.run(["free", "-g"], capture_output=True,
                         text=True).stdout)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_device_mesh((1, 1), ("data", "model"))
        gen = torch.Generator(device="cuda").manual_seed(0)
        tree = {"p": [distribute_tensor(
            torch.randn(rows, 4096, device="cuda", generator=gen), mesh,
            [Shard(0), Replicate()]) for _ in range(12)],
            "b": distribute_tensor(torch.randn(
                64, 64, device="cuda", generator=gen).bfloat16(), mesh,
                [Replicate(), Shard(1)])}
        torch.cuda.synchronize()
        d = tempfile.mkdtemp(prefix="ckpt_io_")
        try:
            t0 = time.perf_counter()
            path = save_checkpoint(d, 2, tree)
            save_ms = (time.perf_counter() - t0) * 1e3
            nbytes = sum(os.path.getsize(os.path.join(path, f))
                         for f in os.listdir(path))
            t0 = time.perf_counter()
            step, got = restore_latest(d, tree)
            torch.cuda.synchronize()
            restore_ms = (time.perf_counter() - t0) * 1e3
        finally:
            shutil.rmtree(d, ignore_errors=True)
        equal = all(torch.equal(a.full_tensor(), b) for a, b in zip(
            tree["p"] + [tree["b"]], got["p"] + [got["b"]]))
    finally:
        dist.destroy_process_group()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"save {save_ms:.1f} ms host, {nbytes} bytes, restore "
          f"{restore_ms:.1f} ms host (warm page cache), step {step}, equal "
          f"{equal}; {smi}", flush=True)
    return 0 if equal and step == 2 else 1


if __name__ == "__main__":
    sys.exit(main())
