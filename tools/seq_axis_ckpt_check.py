#!/usr/bin/env python3
"""Phases 14(e) and 15(c) of ``chip_smoke.py`` alone, on one GPU.

    python3 tools/seq_axis_ckpt_check.py

Runs phase 1 (the card) and phase 2 (the kernel build), then what phase
14(e) compares against -- granite-3-8b at full width with bf16 weights
from ``chip_smoke.SEED``: phase 6's control loop over the 2-shard fleet
mesh, and its f32 loop at 2 layers -- then phase 14(e) itself (the loop
over (fleet 2, seq 2) on cuda:0), then phase 15(c) on a one-rank NCCL
(data 1, model 1) ``DeviceMesh`` (the sharded train state saved after
step 2, restored, re-placed, and step 3 against the uninterrupted one).
Prints chip_smoke's ``[mesh]`` and ``[shard]`` lines and ``[check]``
summaries; exits non-zero when a check fails. Needs a CUDA card; imports
nothing of JAX.
"""
import dataclasses
import socket
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.distributed import ShardPlan
    from repro_torch.distributed.sharding import place_batch
    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models.layers import _rope_freqs_on
    from repro_torch.models.model import make_model
    from repro_torch.models.optim import AdamW, cosine_schedule

    if not torch.cuda.is_available():
        print("seq_axis_ckpt_check: no CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    smi = cs.CARD = cs.phase_card(torch)
    cs.phase_build(build)

    cfg = get_config("granite-3-8b")
    model = make_model(cfg)
    params = model.init(seed=cs.SEED, dtype=torch.bfloat16, device="cuda")
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    model2 = make_model(cfg2)
    small = (cfg2, model2, model2.init(seed=cs.SEED, dtype=torch.float32,
                                       device="cuda"))
    # the RoPE table's one host-to-device copy (the whole script makes it
    # in phase 4) before the sync-checked loop
    _rope_freqs_on(cfg.resolved_head_dim, float(cfg.rope_theta),
                   torch.device("cuda", 0))
    mesh = cs._two_shards()
    fleet_only = cs.phase_control(torch, ops, cfg, model, params, mesh=mesh)
    out = serve.run_control_loop(cs._control_args(serve), cfg2, model2,
                                 small[2], cache_dtype=torch.float32,
                                 mesh=mesh)
    fleet_only["f32_digest"] = cs._digest(out["fe"])
    del out
    res = cs.phase_replicated_axis(torch, ops, cfg, model, params, small,
                                   fleet_only)
    print("[check] 14(e)", res, flush=True)
    del params, small, model, model2
    cs._free(torch)

    toks = [{"tokens": t.cuda()} for t in cs._markov_tokens(
        torch, cfg.vocab_size, cs.TRAIN_B, cs.TRAIN_S, cs.SHARD_STEPS)]
    opt = AdamW(lr=cosine_schedule(3e-4, 2, cs.SHARD_STEPS),
                weight_decay=0.01)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        plan = ShardPlan(make_device_mesh((1, 1), ("data", "model")),
                         "train")
        res = cs.phase_sharded_ckpt(torch, ops, smi, plan, opt,
                                    [place_batch(plan, b) for b in toks])
    finally:
        dist.destroy_process_group()
    print("[check] 15(c)", res, flush=True)
    print(f"[check] done in {time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
