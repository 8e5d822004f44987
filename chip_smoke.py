#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card of the Hopper generation (the kernels build for
``sm_90a``) and the CUDA toolkit's ``nvcc``; imports nothing of JAX or of
the JAX package. Phases, each printed as it runs; any failure raises and
the script exits non-zero:

  1. the card (``nvidia-smi`` name and power limit), torch / CUDA versions,
     and the TF32 settings (both off: f32 parity needs full f32 products);
  2. the kernel build: one ``nvcc`` per ``csrc/*.cu``, all in parallel;
  3. each kernel against its plain PyTorch version on the card, in f32
     (atol/rtol 2e-5) and bf16 (3e-2), at the main path's shapes;
  4. the main path: full-width granite-3-8b (random bf16 weights from a
     seed, bf16 KV cache) served in drain mode by 2 replicas
     (max_batch 8, max_seq 1024) behind ``ClusterFrontend(policy="lc")``,
     16 requests with prompts up to 512 tokens and up to 64 new tokens.
     Launch counts are zeroed just before and read just after: every
     decode step runs flash_decode once per layer, every prefill dispatch
     runs flash_attention once per layer;
  5. the kernel path against the einsum path: full-width bf16 prefill
     last-token logits and first decode logits within a stated tolerance,
     and identical greedy streams at full width cut to 2 layers in f32;
  6. times at the main path's shapes (CUDA-event medians over CUDA-graph
     replays): each kernel, its plain version, the one PyTorch call that
     computes the same function (``scaled_dot_product_attention``, timed
     here only -- the port never calls it) and the bound, the larger of
     bytes / 3.35 TB/s and operations / 989 TFLOP/s (bf16).

The line before the last is the JSON table of kernels; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOLS = {"float32": dict(atol=2e-5, rtol=2e-5),
        "bfloat16": dict(atol=3e-2, rtol=3e-2)}
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12       # dense bf16 tensor-core peak, same source
N_REQUESTS, MAX_PROMPT, MAX_NEW = 16, 512, 64
MAX_BATCH, MAX_SEQ, REPLICAS, SEED = 8, 1024, 2, 0
# full-width bf16, kernel path vs einsum path: the einsum path rounds the
# softmax probabilities to bf16 before P.V and the kernel keeps them in
# f32, and each of the 40 layers rounds its activations to bf16 again, so
# the two agree to a few bf16 steps of the logits' scale, not bitwise
BF16_PATH_TOL = 0.05            # max |delta logits| / max |logits|

KERNELS = {
    "flash_decode": dict(source="src/repro_torch/csrc/flash_decode.cu",
                         replaces="src/repro/kernels/decode_attention.py:27"),
    "flash_attention": dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:29"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- phase 1-3
def phase_card(torch) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(smi)                      # name, power limit as nvidia-smi prints
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"[card] tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")


def phase_build(build) -> None:
    t0 = time.perf_counter()
    built = build.build()
    log(f"[build] {len(built)} kernels in {time.perf_counter() - t0:.1f}s")
    for b in built.values():
        log(f"[build] {b.name}: {b.path} ({b.seconds:.1f}s nvcc)")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")


def _close(name, got, want, dtype, torch) -> float:
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **TOLS[dtype],
                               msg=lambda m: f"{name} {dtype}: {m}")
    return err


def phase_parity(torch, ops, ref) -> dict:
    """Each kernel against its plain version on the same card inputs."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {"flash_decode": 0.0, "flash_attention": 0.0}
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    # flash_decode at the serve pool's head layout, long cache, ragged pos
    B, G, qpg, hd, S = 8, 8, 4, 128, 4096
    pos = torch.tensor([0, S - 1, 100, 1000, 2047, 777, 3000, 64],
                       dtype=torch.int32, device="cuda")
    for dname, dt in dtypes.items():
        q = torch.randn(B, G, qpg, hd, generator=gen, device="cuda").to(dt)
        k = torch.randn(B, S, G, hd, generator=gen, device="cuda").to(dt)
        v = torch.randn(B, S, G, hd, generator=gen, device="cuda").to(dt)
        got = ops.flash_decode(q, k, v, pos)
        torch.cuda.synchronize()
        err = _close("flash_decode", got, ref.flash_decode_ref(q, k, v, pos),
                     dname, torch)
        errs["flash_decode"] = max(errs["flash_decode"], err)
        log(f"[parity] flash_decode B={B} Hq={G * qpg} Hkv={G} hd={hd} "
            f"S={S} pos={pos.tolist()} {dname}: max|err|={err:.3e} "
            f"(atol/rtol {TOLS[dname]['atol']})")
    # flash_attention: ragged and long S, causal and full
    B = 2
    for S in (8, 100, 2048):
        for causal in (True, False):
            for dname, dt in dtypes.items():
                q = torch.randn(B, S, G, qpg, hd, generator=gen,
                                device="cuda").to(dt)
                k = torch.randn(B, S, G, hd, generator=gen,
                                device="cuda").to(dt)
                v = torch.randn(B, S, G, hd, generator=gen,
                                device="cuda").to(dt)
                got = ops.flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
                err = _close("flash_attention", got,
                             ref.flash_attention_ref(q, k, v, causal=causal),
                             dname, torch)
                errs["flash_attention"] = max(errs["flash_attention"], err)
                log(f"[parity] flash_attention B={B} Hq={G * qpg} Hkv={G} "
                    f"hd={hd} S={S} causal={causal} {dname}: "
                    f"max|err|={err:.3e} (atol/rtol {TOLS[dname]['atol']})")
    return errs


# ------------------------------------------------------------------ phase 4
def _serve_args(serve, backend="kernel"):
    return serve.build_parser().parse_args(
        ["--policy", "lc", "--replicas", str(REPLICAS), "--max-batch",
         str(MAX_BATCH), "--max-seq", str(MAX_SEQ), "--requests",
         str(N_REQUESTS), "--seed", str(SEED), "--attn-backend", backend,
         "--device", "cuda"])


def phase_serve(torch, ops, cfg, model, params, workload):
    """The main path, counted: drain mode at full width."""
    from repro_torch.launch import serve

    args = _serve_args(serve)
    torch.cuda.synchronize()
    ops.reset_launches()
    fe, reps, wall = serve.run_drain_mode(args, cfg, model, params,
                                          cache_dtype=torch.bfloat16,
                                          workload=workload)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    steps = sum(r.steps for r in reps)
    dispatches = sum(r.prefill_dispatches for r in reps)
    shapes = sorted(reps[0]._shapes)
    log(f"[serve] launches {launches}; decode steps {steps}, prefill "
        f"dispatches {dispatches}, layers {cfg.num_layers}; prefill shapes "
        f"{shapes}; syncs {sum(r.syncs for r in reps)}, sync wait "
        f"{sum(r.sync_wait for r in reps):.3f}s")
    if len(fe.finished) != N_REQUESTS or not all(r.done
                                                 for r in fe.finished):
        raise AssertionError(f"{len(fe.finished)}/{N_REQUESTS} finished")
    want = {"flash_decode": cfg.num_layers * steps,
            "flash_attention": cfg.num_layers * dispatches}
    if launches != want or min(launches.values()) == 0:
        raise AssertionError(f"launches {launches} != expected {want}")
    return reps, launches, shapes


# ------------------------------------------------------------------ phase 5
def _bucket(prompts, device, torch):
    """Right-padded pow2 bucket of ``prompts`` with their lengths, as the
    engine's bucketed prefill builds it."""
    from repro_torch.serving.engine import pow2_bucket

    sb = pow2_bucket(max(map(len, prompts)))
    toks = torch.zeros((len(prompts), sb), dtype=torch.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p, dtype=torch.int32)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    return {"tokens": toks.to(device), "lengths": lens.to(device)}


def phase_paths(torch, cfg, model, params, workload):
    """Kernel path vs einsum path on the card."""
    from repro_torch.launch import serve
    from repro_torch.models.model import make_model

    batch = _bucket([w["prompt"] for w in workload[:MAX_BATCH]], "cuda",
                    torch)
    out = {}
    for backend in ("kernel", "einsum"):
        logits, cache, pos = model.prefill(
            params, batch, cache_len=MAX_SEQ, cache_dtype=torch.bfloat16,
            attn_backend=backend)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        dlogits, _ = model.decode(params, cache, tok, pos,
                                  attn_backend=backend)
        out[backend] = (logits.float(), dlogits.float(), tok)
        del cache
    for i, what in enumerate(("prefill last-token", "first decode")):
        k, e = out["kernel"][i], out["einsum"][i]
        rel = ((k - e).abs().max() / e.abs().max()).item()
        agree = (k.argmax(-1) == e.argmax(-1)).float().mean().item()
        log(f"[paths] bf16 full width {what} logits: max|kernel-einsum| / "
            f"max|einsum| = {rel:.3e} (tolerance {BF16_PATH_TOL}); argmax "
            f"agreement {agree:.3f}")
        if not rel <= BF16_PATH_TOL:
            raise AssertionError(f"{what} logits differ by {rel:.3e}")
    torch.cuda.empty_cache()

    # f32, full width, 2 layers: identical greedy streams through the
    # whole drain-mode path
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    model2 = make_model(cfg2)
    params2 = model2.init(seed=SEED, dtype=torch.float32, device="cuda")
    streams = {}
    for backend in ("kernel", "einsum"):
        fe, _, _ = serve.run_drain_mode(_serve_args(serve, backend), cfg2,
                                        model2, params2,
                                        cache_dtype=torch.float32,
                                        workload=workload)
        streams[backend] = sorted((r.rid, tuple(r.output), r.first_token_time,
                                   r.finish_time) for r in fe.finished)
    same = streams["kernel"] == streams["einsum"]
    n_tok = sum(len(s[1]) for s in streams["kernel"])
    log(f"[paths] f32 full width, 2 layers: {len(streams['kernel'])} "
        f"requests, {n_tok} tokens, streams identical: {same}")
    if not same:
        raise AssertionError("f32 greedy streams differ between kernel and "
                             "einsum paths")


# ------------------------------------------------------------------ phase 6
def _graph_ms(torch, fn, n_inner: int, reps: int = 10) -> float:
    """Median over ``reps`` CUDA-graph replays of ``fn`` (which makes
    ``n_inner`` calls), per call, from CUDA events."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n_inner)
    return statistics.median(times)


def _bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_times(torch, F, ops, ref, cfg, reps, workload, shapes):
    """Kernel, plain and library times at the main path's shapes."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    G, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    qpg = cfg.num_heads // G
    L = cfg.num_layers
    bf = torch.bfloat16
    rows = {}

    # flash_decode: one decode step over the served pool's 40 layer views
    # (each launch reads another layer, as the decode step does), at the
    # fill depth of the first 8 requests half-way through their decode
    pool = reps[0].cache
    pos = torch.tensor([min(len(w["prompt"]) + MAX_NEW // 2, MAX_SEQ - 1)
                        for w in workload[:MAX_BATCH]], dtype=torch.int32,
                       device="cuda")
    B = MAX_BATCH
    q = torch.randn(B, G, qpg, hd, generator=gen, device="cuda").to(bf)
    views = [(pool["k"][li], pool["v"][li]) for li in range(L)]
    mask = (torch.arange(MAX_SEQ, device="cuda")[None, :]
            <= pos[:, None])[:, None, None, :]
    qs = q.reshape(B, G * qpg, 1, hd)
    sdpa_out = F.scaled_dot_product_attention(
        qs, views[0][0].transpose(1, 2), views[0][1].transpose(1, 2),
        attn_mask=mask, enable_gqa=True)
    torch.testing.assert_close(
        sdpa_out.reshape(B, G, qpg, hd).float(),
        ref.flash_decode_ref(q, *views[0], pos).float(), **TOLS["bfloat16"])
    ms = _graph_ms(torch, lambda: [ops.flash_decode(q, k, v, pos)
                                   for k, v in views], L)
    plain = _graph_ms(torch, lambda: [ref.flash_decode_ref(q, k, v, pos)
                                      for k, v in views], L)
    lib = _graph_ms(torch, lambda: [F.scaled_dot_product_attention(
        qs, k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
        enable_gqa=True) for k, v in views], L)
    filled = int((pos.long() + 1).sum())
    esz = 2
    nbytes = (2 * B * G * qpg * hd * esz          # q in, out
              + 2 * filled * G * hd * esz         # K and V rows 0..pos[b]
              + B * 4)                            # pos
    flops = 4 * hd * G * qpg * filled             # q.k and p.v per position
    bound, by = _bound(nbytes, flops)
    rows["flash_decode"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                bound_by=by, library_ms=lib)
    log(f"[times] flash_decode B={B} Hq={G * qpg} Hkv={G} hd={hd} "
        f"S={MAX_SEQ} pos={pos.tolist()} bf16: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound {bound:.4f} ms ({by}: "
        f"{nbytes} B, {flops} flop)")

    # flash_attention: the largest bucketed prefill shape the run saw
    kb, sb = max((s[1], s[2]) for s in shapes if s[0] == "bucketed")
    q = torch.randn(kb, sb, G, qpg, hd, generator=gen, device="cuda").to(bf)
    k = torch.randn(kb, sb, G, hd, generator=gen, device="cuda").to(bf)
    v = torch.randn(kb, sb, G, hd, generator=gen, device="cuda").to(bf)
    q4 = q.reshape(kb, sb, G * qpg, hd).transpose(1, 2)
    n = 10
    ms = _graph_ms(torch, lambda: [ops.flash_attention(q, k, v, causal=True)
                                   for _ in range(n)], n)
    plain = _graph_ms(torch, lambda: [ref.flash_attention_ref(q, k, v)
                                      for _ in range(n)], n)
    lib = _graph_ms(torch, lambda: [F.scaled_dot_product_attention(
        q4, k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
        enable_gqa=True) for _ in range(n)], n)
    nbytes = 2 * (2 * kb * sb * G * qpg * hd + 2 * kb * sb * G * hd)
    flops = 4 * hd * kb * G * qpg * sb * (sb + 1) // 2
    bound, by = _bound(nbytes, flops)
    rows["flash_attention"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                   bound_by=by, library_ms=lib)
    log(f"[times] flash_attention B={kb} S={sb} Hq={G * qpg} Hkv={G} "
        f"hd={hd} causal bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"sdpa {lib:.4f} ms, bound {bound:.4f} ms ({by}: {nbytes} B, "
        f"{flops} flop)")
    return rows


def phase_step_times(torch, model, params, reps, workload):
    """Host-clock times of one decode step and one prefill of the served
    model, each ending in a synchronise (the engine's own blocking fetch),
    and the decode step's device time alone."""
    eng = reps[0]
    pos = torch.tensor([min(len(w["prompt"]) + MAX_NEW // 2, MAX_SEQ - 1)
                        for w in workload[:MAX_BATCH]], dtype=torch.int32,
                       device="cuda")
    tok = torch.ones((MAX_BATCH, 1), dtype=torch.int32, device="cuda")

    def decode():
        logits, _ = model.decode(params, eng.cache, tok, pos)
        return torch.argmax(logits, dim=-1).cpu()

    batch = _bucket([w["prompt"] for w in workload[:MAX_BATCH]], "cuda",
                    torch)

    def prefill():
        logits, _, _ = model.prefill(params, batch,
                                     cache_len=batch["tokens"].shape[1],
                                     cache_dtype=torch.bfloat16)
        return torch.argmax(logits, dim=-1).cpu()

    # the same decode step replayed from a CUDA graph: device time alone,
    # without the host's ~2,800 launches
    device_ms = _graph_ms(torch, lambda: model.decode(params, eng.cache, tok,
                                                      pos), 1, reps=5)
    out = {}
    for name, fn, n in (("decode step", decode, 10),
                        ("prefill", prefill, 3)):
        fn()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times)
    log(f"[steps] granite-3-8b bf16, {MAX_BATCH} slots: decode step "
        f"{out['decode step']:.2f} ms (host clock, median of 10), of which "
        f"the device is busy {device_ms:.2f} ms (CUDA-graph replay, median "
        f"of 5): idle share {1 - device_ms / out['decode step']:.2f}; "
        f"prefill {tuple(batch['tokens'].shape)} {out['prefill']:.2f} ms "
        f"(host clock, median of 3)")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a CUDA GPU", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {ROOT / 'chip_smoke.py'}"
              "; run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import prompt_workload
    from repro_torch.kernels import build, ops, ref
    from repro_torch.models.model import make_model

    t_start = time.perf_counter()
    phase_card(torch)
    phase_build(build)
    errs = phase_parity(torch, ops, ref)

    cfg = get_config("granite-3-8b")
    model = make_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=SEED, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    log(f"[model] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, hd "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
        f"{cfg.param_count() / 1e9:.2f} B params in bf16, random from seed "
        f"{SEED}, built in {time.perf_counter() - t0:.1f}s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    workload = prompt_workload(cfg.vocab_size, N_REQUESTS, seed=SEED,
                               max_len=MAX_PROMPT, max_new=MAX_NEW)
    reps, launches, shapes = phase_serve(torch, ops, cfg, model, params,
                                         workload)
    phase_paths(torch, cfg, model, params, workload)
    rows = phase_times(torch, F, ops, ref, cfg, reps, workload, shapes)
    phase_step_times(torch, model, params, reps, workload)
    log(f"[done] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
        f"{time.perf_counter() - t_start:.1f}s")

    table = [dict(name=name, route="cuda", **KERNELS[name],
                  launches=launches[name], max_abs_err=errs[name],
                  **rows[name]) for name in KERNELS]
    print(json.dumps({"kernels": table}), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
