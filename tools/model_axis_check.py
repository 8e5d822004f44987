#!/usr/bin/env python3
"""Phase 14(d) of ``chip_smoke.py`` alone, on one GPU.

    python3 tools/model_axis_check.py

Runs phase 1 (the card) and phase 2 (the kernel build), then what phase
14(d) compares against -- granite-3-8b at full width with bf16 weights
from ``chip_smoke.SEED``: phase 6's control loop unsharded and over the
2-shard fleet mesh, and phase 8's f32 oracle at 2 layers -- then phase
14(d) itself (the loop over (fleet 2, model 2) on cuda:0, the f32 loops
over (fleet 2, model 2) and (fleet 2, data 2), the kernels at a model
device's shapes), then the ssm archs' f32 loops over (fleet 1, model 2).
Prints chip_smoke's ``[mesh]`` lines and ``[check]`` summaries; exits
non-zero when a check fails. Needs a CUDA card; imports nothing of JAX.
"""
import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch import serve
    from repro_torch.models.layers import _rope_freqs_on
    from repro_torch.models.model import make_model

    if not torch.cuda.is_available():
        print("model_axis_check: no CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    cs.CARD = cs.phase_card(torch)
    cs.phase_build(build)

    def small_of(cfg):
        cfg2 = dataclasses.replace(cfg, num_layers=2)
        m2 = make_model(cfg2)
        return (cfg2, m2, m2.init(seed=cs.SEED, dtype=torch.float32,
                                  device="cuda"))

    def oracle_of(small):
        out = serve.run_control_loop(cs._control_args(serve), *small,
                                     cache_dtype=torch.float32)
        digest = cs._digest(out["fe"])
        del out
        cs._free(torch)
        return digest

    cfg = get_config("granite-3-8b")
    model = make_model(cfg)
    params = model.init(seed=cs.SEED, dtype=torch.bfloat16, device="cuda")
    small = small_of(cfg)
    # the RoPE table's one host-to-device copy (the whole script makes it
    # in phase 4) before the sync-checked loop
    _rope_freqs_on(cfg.resolved_head_dim, float(cfg.rope_theta),
                   torch.device("cuda", 0))
    control = cs.phase_control(torch, ops, cfg, model, params)
    oracle = oracle_of(small)
    fleet_only = cs.phase_control(torch, ops, cfg, model, params,
                                  mesh=cs._two_shards())
    res = cs.phase_model_axis(torch, F, ops, ref, cfg, model, params,
                              control, small, oracle, fleet_only)
    print("[check] granite", {k: v for k, v in res.items()
                              if k != "kernels"}, flush=True)
    print("[check] kernels", res["kernels"], flush=True)
    del model, params, small
    cs._free(torch)
    for name in cs.SSM_ARCHS:
        c = get_config(name)
        sm = small_of(c)
        print("[check]", name,
              cs.phase_model_axis_ssm(torch, ops, c, sm, oracle_of(sm)),
              flush=True)
        del sm
        cs._free(torch)
    print(f"[check] done {time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
