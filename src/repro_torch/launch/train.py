"""End-to-end training entry point (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \
        --scale 100m --steps 300 --batch 16 --seq 256

Trains a scaled-down variant of the selected architecture on the synthetic
Markov corpus with the whole stack: AdamW with a cosine schedule and
clipping, the sequence-chunked CE, gradient accumulation
(``--grad-accum``), checkpoints with auto-resume (kill it mid-run and
relaunch with the same ``--ckpt-dir``: it continues) and metrics lines.
The flags are the reference's, plus ``--device`` (default ``cuda``;
``--device cpu`` runs on the CPU, and asking for a card where there is
none raises). Weights come from a ``torch.Generator`` seeded with
``--seed``; the tokens are the reference's (same seed, same tokens). A
vlm batch's patches are zeros, as in the reference; an audio batch's
frames are one draw of a generator seeded 0, times 0.1 (the reference
draws them with ``jax.random``). ``float(loss)`` is read every step, as
the reference does; the train step itself reads nothing back.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import restore_latest, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataLoader, MarkovCorpus
from repro_torch.device import resolve_device
from repro_torch.models.model import make_model, make_train_step
from repro_torch.models.optim import AdamW, cosine_schedule

SCALES = {
    # ~100M-param decoder (whatever the arch family, same budget)
    "100m": dict(num_layers=10, d_model=640, num_heads=10, num_kv_heads=5,
                 head_dim=64, d_ff=2560, vocab_size=32000, max_seq_len=4096),
    "20m": dict(num_layers=6, d_model=320, num_heads=5, num_kv_heads=5,
                head_dim=64, d_ff=1280, vocab_size=8000, max_seq_len=2048),
    "smoke": dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                  head_dim=32, d_ff=256, vocab_size=512, max_seq_len=512),
}


def scaled_config(arch: str, scale: str):
    """``arch`` at one of ``SCALES`` (its family's structure kept), or
    ``"full"``: the published config."""
    cfg = get_config(arch)
    if scale == "full":
        return cfg
    kw = dict(SCALES[scale])
    if cfg.family in ("ssm", "hybrid"):
        kw.update(num_heads=cfg.num_heads and 8, num_kv_heads=cfg.num_kv_heads
                  and 8, d_ff=kw["d_ff"], ssm_state=32, ssm_head_dim=32)
        if cfg.family == "ssm":
            kw.update(num_heads=0, num_kv_heads=0, d_ff=0)
    if cfg.uses_moe:
        kw.update(num_experts=min(cfg.num_experts, 8),
                  num_experts_per_tok=cfg.num_experts_per_tok,
                  moe_d_ff=kw["d_ff"] // 2)
    if cfg.is_encoder_decoder:
        kw.update(encoder_layers=4, encoder_seq_len=128)
    if cfg.family == "vlm":
        kw.update(num_patches=64)
    return dataclasses.replace(cfg, name=f"{arch}-{scale}", **kw)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--scale", default="100m", choices=[*SCALES, "full"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--warmup", type=int, default=40)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (cuda, or cpu)")
    return ap


def main(argv=None):
    """Train with ``argv`` (the command line when None). Returns
    (final loss: the mean of the last 10 steps, unigram entropy)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = scaled_config(args.arch, args.scale)
    model = make_model(cfg, tp=1)
    print(f"[train] arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"family={cfg.family}", flush=True)

    params = model.init(seed=args.seed, dtype=torch.float32, device=device)
    opt = AdamW(lr=cosine_schedule(args.lr, args.warmup, args.steps),
                weight_decay=0.01)
    opt_state = opt.init(params)
    step0 = 0
    if args.ckpt_dir:
        # every leaf comes back whole, on its counterpart's device and in
        # its dtype; a sharded run re-places the restored tree with
        # distributed.sharding.place_params, as the reference's jitted
        # step re-places the whole arrays it is given
        step, restored = restore_latest(args.ckpt_dir,
                                        {"params": params, "opt": opt_state})
        if step is not None:
            params, opt_state = restored["params"], restored["opt"]
            step0 = step
            print(f"[train] resumed from step {step0}", flush=True)

    corpus = MarkovCorpus(cfg.vocab_size, seed=args.seed)
    loader = DataLoader(corpus, args.batch, args.seq, seed=args.seed)
    train_step = make_train_step(model, opt, grad_accum=args.grad_accum)
    extras = {}
    if cfg.family == "vlm":
        extras["patch_embeds"] = torch.zeros(
            (args.batch, cfg.num_patches, cfg.d_model), device=device)
    if cfg.family == "audio":
        gen = torch.Generator(device=device).manual_seed(0)
        extras["frame_embeds"] = torch.randn(
            (args.batch, cfg.encoder_seq_len, cfg.d_model), generator=gen,
            device=device) * 0.1

    losses = []
    t0 = time.time()
    for step in range(step0, args.steps):
        batch = dict(extras, tokens=torch.from_numpy(
            next(loader)["tokens"]).to(device))
        params, opt_state, metrics = train_step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            toks = (step - step0 + 1) * args.batch * args.seq
            print(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"tok/s {toks/max(dt,1e-9):.0f}", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step + 1,
                            {"params": params, "opt": opt_state})
    uni = corpus.unigram_entropy()
    final = float(np.mean(losses[-10:]))
    print(f"[train] final loss {final:.4f} (unigram entropy {uni:.3f}, "
          f"start {losses[0]:.3f})", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"arch": cfg.name, "losses": losses,
                       "unigram_entropy": uni, "final": final}, f)
    return final, uni


if __name__ == "__main__":
    main()
