#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card of the Hopper generation (the kernels build for
``sm_90a``) and the CUDA toolkit's ``nvcc``; imports nothing of JAX or of
the JAX package. Phases, each printed as it runs; any failure raises and
the script exits non-zero:

  1. the card (``nvidia-smi`` name and power limit), torch / CUDA versions,
     and the TF32 settings (both off: f32 parity needs full f32 products);
  2. the kernel build: one ``nvcc`` per ``csrc/*.cu``, all in parallel,
     with ptxas's registers, shared memory and spills per instantiation;
  3. each kernel against its plain PyTorch version on the card:
     flash_decode and flash_attention in f32 (atol/rtol 2e-5) and bf16
     (3e-2), at the drain mode's shapes and at the control loop's (decode
     over a pool of 8 x 4096 -- 32 of the kernel's 128-position chunks --
     at depths 1, 4096, 128, 129 and others, and over fleet slabs of 16
     and 32 rows x max_seq 256 with ragged depths, one row of each case
     also alone, which must give its in-batch result bit for bit;
     attention over S in {1, 4, 8, 100, 2048}, causal and full, and fleet
     prefills of K in {1,2,4,8} prompts of bucket 4, 8 or 16), at
     granite-3-8b's and mistral-nemo-12b's head layout (8 kv x 4 q heads,
     hd 128), zamba2-2.7b's shared block (32 x 1, hd 80) and
     command-r-35b's layers (8 x 8, hd 128; not served); gcn_layer in f32
     (1e-5, the reference's tolerance) at the control plane's shapes and
     beyond, relu on and off, and batched, and the balancer's whole action
     in one launch (gcn_actor: both GCN layers, the head, the masked
     softmax) at the serve defaults and the paper's 16-node cluster, with
     a node down and noise, batched, every node down, at the largest graph
     one block holds and one node above it (the layered path); ssd_scan in f32
     (1e-4, the reference's tolerance) at mamba2-1.3b's and zamba2-2.7b's
     heads, at the drain mode's prefills (8 x 512, 2 x 96, 8 x 200) and
     the control loop's (K x 8 or 16) and at T 24, with ragged lengths, so
     that each arch reaches every (step tile, heads a block)
     instantiation; ssd_decode (the decode step of the SSM state) at
     mamba2-1.3b's heads over 128 to 384 rows and zamba2-2.7b's over 128,
     bf16 x, B and C and an f32 state as the model runs it, every row
     written and 3 in 4 (a padded write buffer): the written state equal
     to the plain version's bit for bit, y within 1e-4, and timed there
     (kernel, plain, the byte bound);
  4.-8. for each served architecture in turn -- granite-3-8b (dense),
     mamba2-1.3b (ssm), zamba2-2.7b (hybrid), then mistral-nemo-12b
     (dense, queries 32 x 128 = 4096 wide against d_model 5120) -- each at
     full width with random bf16 weights from a seed (bf16 KV and conv
     state, f32 SSM state), depth not cut. Every decode dispatch replays a
     captured CUDA graph (a drain replica's step, the fleet's one or four
     micro-steps), whose launches ``ops.LAUNCHES`` counts per replay:
  4. drain mode: 2 replicas (max_batch 8, max_seq 1024) behind
     ``ClusterFrontend(policy="lc")``, 16 requests with prompts up to 512
     tokens and up to 64 new tokens. Launch counts are zeroed just before
     and read just after: every decode step runs flash_decode once per
     attention layer (the hybrid's shared block once per invocation),
     every prefill dispatch runs flash_attention as often and ssd_scan
     once per mamba layer, and every decode step ssd_decode once per mamba
     layer; ssd_scan never runs in decode;
  5. the kernel path against the einsum path: full-width prefill
     last-token logits and first decode logits (both paths decoding the
     einsum prefill's token) within a stated tolerance (granite in bf16;
     the ssm family in f32, its bf16 gap reported), and
     identical greedy streams at full width cut to 2 layers in f32 (and
     the replicas' graph-replayed steps against eager ones); for the
     dense archs then one fleet decode dispatch of a sub-step round (some slab
     rows step, the others must keep their cache bit for bit) at 32 rows,
     f32, 2 layers, kernel logits against einsum logits;
  6. the control loop: ``run_control_loop`` with ``--policy ours
     --autoscale gpso`` -- the elastic frontend with fleet-batched decode
     and admission and the async tick, the GCN+DDPG balancer and GPSO on
     the plane's own stream -- for 40 ticks, then drained. Counts zeroed
     just before and read just after: gcn_layer once per plane tick (the
     balancer's action), the model's kernels per fleet dispatch as in
     drain mode; every request
     finishes, the ledger balances, GPSO scales up, no host sync hides in
     the engine (torch's sync debug mode), and every tick keeps the async
     tick's sync contract (``async_tick_violations``). The ``[graphs]``
     line: the decode graphs' captures, recaptures after a slab growth,
     replays and pool memory, and the largest group's dispatch through the
     engine (host ms to enqueue, to the results, device ms, idle share).
     Then ``--decode-block 4`` (``phase_block``): the loop at full width,
     counted (blocks engaged, fewer syncs, launches of the micro-steps; its
     contents and clocks against K = 1 reported), the contents at 2 layers
     in f32 equal to K = 1's, and the reference's bounded case (one
     replica, 6 requests) with equal contents and a lag of 0 to 3 ticks.
     mistral-nemo-12b then runs the loop under ``--clients 16`` and as
     ``--cells 2 --hierarchy`` with cell 0 blacked out (ledger balanced,
     nothing served twice, launches counted). For granite, one
     GPSO plan's host time, split into the random key's own work and the
     rest, and the plane's balance host ms a tick with the action fused
     against layered (two gcn_layer launches and the eager head), the
     control loop run in turns (each digest equal to the first run's),
     then the balance phase alone at 2 to 144 nodes, fused against
     layered;
  7. times (CUDA-event medians over CUDA-graph replays): each kernel, its
     plain version, the one PyTorch call that computes the same function
     where there is one (timed here only -- the port never calls it) and
     the bound, the larger of bytes / 3.35 TB/s and operations over the
     peak rate of their type (989 TFLOP/s bf16, 67 TFLOP/s f32; ssd_scan's
     products run as three TF32 passes, so 3 x operations / 495 TFLOP/s,
     with the f32 SIMT bound printed beside it). The JSON
     rows are timed at the control loop's shapes (granite's largest slab
     and fleet prefill, the balancer's first GCN layer and its whole
     action -- against the layered chain, its yardstick -- mamba2's largest
     fleet prefill for ssd_scan); the drain mode's shapes, zamba2's and
     head dim 80 are timed and printed beside them. Then each model's
     drain-mode decode step's (eager and as its graph) and prefill's host
     and device times;
  8. the control loop's oracles: the same run with ``--no-async`` (eager
     decode, the graphs' oracle) gives the same digest of (rid, output,
     first-token and finish ticks) in bf16, and at full width cut to 2
     layers in f32 the fleet kernel run, ``--no-fleet`` and
     ``--attn-backend einsum`` do too.
  9. chunked prefill and the int8 KV cache, at full width with the bf16
     weights. ``--chunk-len`` for granite-3-8b, mamba2-1.3b and
     zamba2-2.7b with an f32 cache (a replica chunks only with one): drain
     mode with ``--chunk-len 128`` and the control loop of phase 6 with
     ``--chunk-len 4``, counted -- every chunk dispatch launches
     flash_attention (at its cache offset) once per attention layer and
     ssd_scan (from the carried state) once per mamba layer, each run's
     launches are those of its dispatches, every request finishes, the
     ledger balances -- with the streams against single-shot's, one chunk
     dispatch's host / device ms and the chunked prompts' TTFT reported;
     at 2 layers in f32 chunked equals single-shot on both backends. The
     int8 cache for granite-3-8b (``cache_dtype="int8"``): drain mode and
     the control loop with int8 replicas, counted (flash_decode over the
     int8 pool once a layer a step), the async digest equal to the int8
     ``--no-async`` oracle's, at 2 layers in f32 the kernel path equal to
     einsum's; pool bytes, the decode dispatch's host / device ms against
     the bf16 cache's and the streams against phase 6's reported. Phase 3
     also holds this round's kernel variants to their plain versions
     (ssd_scan from a random ``init_state``, flash_attention at ragged
     ``q_offset`` over pool rows, flash_decode over an int8 pool), and
     phase 7 times them (``variants`` in the kernels line).
 10. the MoE family at full width, depth cut to fit the card in bf16
     (``MOE_DEPTH``): grok-1-314b at 4 of its 64 layers (8 experts, top-2,
     48 q / 8 kv heads: qpg 6) and llama4-maverick-400b-a17b at one layer
     group of its 24 (an MoE layer of 128 experts, top-1, with the shared
     expert, then a dense layer; 40 q / 8 kv heads: qpg 5); phase 3 holds
     both attention kernels to their plain versions at these two head
     layouts. Each runs drain mode, counted (exact-length single admits:
     flash_attention once a layer an admit, flash_decode once a layer a
     step), and prints a ``[moe]`` line: the decode step's device ms split
     into the MoE layers and the rest, the expert weights' bytes a step
     against their bound at 3.35 TB/s, one single admit's host and device
     ms, the peak device memory, the card's name and power limit; then
     both attention kernels timed at its heads. grok-1-314b also runs the
     kernel path against the einsum path, recording every layer's top-k
     set a token: in f32 at 1 layer (about 26 GB) every row's logits
     within F32_PATH_TOL and identical drain streams (kernel, einsum,
     eager steps); in bf16 at 4 layers the top-k sets that differ are
     counted and the logit gap is held to BF16_PATH_TOL over the rows
     whose every token routes alike (a flipped token runs other experts,
     so elsewhere the gap is reported only). Then the control loop of
     phase 6 at 4 layers with its checks: graph-replayed fleet decodes,
     the async tick's sync contract with each exact-length admit's eager
     sync counted as the replica's own, and no other sync in the engine.
 11. the paper's experiment over the fluid simulator, and the control
     plane's training: (a) gcn_layer_bwd (the GCN layer's backward, dW,
     db and dX in one launch) against its plain version (autograd through
     ``ref.gcn_layer_ref``) at the DDPG update's shapes -- 128 graphs of 8
     and 16 nodes, 36 -> 64 with relu and 64 -> 64 without, dX on and off
     -- within 1e-5, two launches bit-equal; times of one GCN's backward
     against the plain version, a ``torch.matmul`` chain and the bound,
     and of gcn_layer (the forward) at the same shapes against its plain
     version, a ``matmul``/``addmm`` chain and the bound;
     (b) one ``ddpg_update`` at the paper's ClusterConfig() (16 nodes,
     batch 128) on the card against the CPU within 1e-4, its launches as
     derived, its host and device ms and idle share; (c) an RRA episode
     of 400 ticks at 8 nodes, the sim's tick on the card against the CPU
     (1e-5, replicas equal); (d) ``python -m repro_torch.sim.experiment``
     at its defaults (the GRU's training, the balancer's 4 episodes, one
     episode a method, the table), counted -- gcn_layer once an OURS tick
     plus 9 an update, gcn_layer_bwd 4 an update -- every summary finite
     and OURS's mean response below RRA's, with each stage's seconds,
     host ms a tick per method and a forecaster step's ms; (e) a training
     episode of OURS at ClusterConfig(), counted the same way, with its
     syncs a tick.
 12. the vlm and audio families at full width and depth, bf16 weights
     from seed 0, through the engine API with per-request extras (the
     reference's CLI reaches neither): both attention kernels against
     their plain versions at the new shapes in f32 and bf16, q drawn at 3x
     so the outputs are O(1), each also held to an rms-relative error
     (internvl2-2b's
     prefill of 1,025 patches + 511 tokens, causal, qpg 2, hd 128;
     whisper-base's encoder over 1,500 frames and its decoder's
     cross-attention of 127 queries over them, full, qpg 1, hd 64;
     flash_decode over internvl2-2b's 3,073-position pool and whisper's
     self cache and 1,500-position cross cache at position 1,499); then
     per arch a drain of 16 requests with extras on one ReplicaEngine of
     8 slots (internvl2-2b at max_seq 2048, so the reference's retirement,
     which counts the patch prefix, cuts no request; whisper-base at its
     own 448), counted -- flash_attention 24 an admit and flash_decode 24
     a step for internvl2-2b, 18 and 12 for whisper-base (encoder, self,
     cross) -- every request finished with a non-empty stream; a single
     admit's host ms (staging its extras included) and device ms; the
     drain's own full-slot decode steps, host ms against the device ms of
     their graph replays (CUDA events), and their idle share; tok/s;
     the kernels timed at its shapes; and in f32 the first four requests
     alone through the kernel and the einsum paths, their logit gap at
     prefill and the first decode step held to F32_PATH_TOL and their
     greedy streams compared.
 13. model training (``python -m repro_torch.launch.train``'s stack),
     which runs no kernel: the reference trains through einsum attention
     and ``ssd_chunked``, and the kernels have no backward. granite-3-8b
     reduced with the same weights on the CPU and the card: the first
     gradient within 1e-4 of each leaf's largest |g|, three AdamW steps'
     losses within 1e-5; the guard (flash_attention, ssd_scan,
     flash_decode under grad raise and launch nothing). granite-3-8b at
     full width, 4 of 40 layers (0.998 B params), f32 params and moments,
     B 4 x S 1,024 Markov tokens: ``remat="full"`` against ``"none"`` (loss
     and gradients within 1e-6, lower peak memory), ``grad_accum=2``
     against 1 (the reference's 5e-5 / 5e-4), then 20 steps, counted (no
     launches), the loss falling: tok/s, host ms against the CUDA-event
     span and the profiler's busy time, idle share, the AdamW update's
     share, peak memory against its reckoning, f32 MFU against 67
     TFLOP/s. mamba2-1.3b at full width, 8 of 48 layers, 5 steps. The
     training CLI in this process at the reference's defaults (100m, 300 steps
     of 16 x 256, checkpoints every 100): the final loss below 0.75 x the
     first, reported beside the unigram entropy; rerun to 320 steps, it
     resumes from step 300; then the other families at 20m, 20 steps
     each, losses finite and falling.
 14. fleets of vlm and audio replicas, and fleet-mesh serving. (a) runs
     inside phase 12, on its bf16 models and requests: the 16 requests
     with extras through an ``ElasticClusterFrontend`` of 2 nodes, one
     replica each (fleet batching and the async tick), ticked until
     drained, counted -- flash_attention per exact-length admit as in
     phase 12, flash_decode 24 (internvl2-2b) or 12 (whisper-base) per
     fleet decode dispatch -- every request finished, the ledger
     balanced, the async tick's sync contract kept, no host sync in the
     engine but the admits' own; the fleet decode dispatch's host and
     device ms and idle share printed beside phase 12's standalone step;
     at 2 layers in f32 the fleet's streams and clocks equal
     ``fleet_batch=False``'s. (b) runs inside granite-3-8b's phases:
     phase 6's control loop over an explicit 2-shard fleet mesh on cuda:0
     (``launch.mesh.make_mesh`` with the device listed twice), counted and
     sync-checked as phase 6, its dispatch and sync counts, per tick too,
     equal to the unsharded run's, every slab cap divisible by 2, the
     launches those of the shards' own runs (a masked sub-step round runs
     only on the shards holding a stepping row), bf16 streams that differ
     counted; at 2 layers in f32 its digest equal to phase 8's fleet run;
     the CLI with ``--devices 1`` on the card, and ``--devices 2`` raising
     on a one-card machine. (c) ``distributed.seq_kv.
     seq_sharded_flash_decode`` on a (1, 2) mesh over cuda:0 at granite's
     heads (32 q / 8 kv, hd 128), S 4,096, pos 0, 100, 2,047 and 4,095,
     in f32 within 2e-5 of flash_decode's plain version. (d) the fleet
     mesh over ``model`` and ``data``, every device cuda:0: phase 6's
     loop over (fleet 2, model 2), each replica's kv heads split 4 and 4,
     counted and sync-checked -- every kernel of a dispatch once a model
     device, counts (per tick too) equal to the unsharded run's, decode
     steps as CUDA graphs, each model device's peak slab bytes half the
     (fleet 2) run's, bf16 streams that differ and tok/s reported, one
     dispatch's host and device ms split against whole; at 2 layers in
     f32 the digests over (fleet 2, model 2) and (fleet 2, data 2) equal
     phase 8's; flash_decode, flash_attention and ssd_scan against their
     plain versions and timed at a model device's shapes (4 kv heads x
     qpg 4 over the 32-row slab, the loop's fleet prefill; 32 and 40 SSD
     heads). mamba2-1.3b and zamba2-2.7b, inside their own phases: the
     f32 2-layer loop over (fleet 1, model 2) equal to their phase 8
     digests, every leaf split, each kernel twice a dispatch. (e) the
     fleet mesh over an axis that names no part of the slab, which the
     slab is replicated over: phase 6's loop over (fleet 2, seq 2), every
     device cuda:0, counted and sync-checked, its decode, admission and
     sync counts (per tick too) and its flash_decode and flash_attention
     launches equal to (b)'s (fleet 2) run's (its row blocks are that
     run's: each runs on index 0 of ``seq``), and at 2 layers in f32 its
     digest equal to (b)'s; within 20 s.

 15. the parameter half of multi-device. (a) A one-rank NCCL process group
     on cuda:0 and a (data=1, model=1) ``DeviceMesh``: phase 13's
     granite-3-8b configuration (full width, 4 of 40 layers, f32, TF32
     off, B 4 x S 1,024 Markov tokens, seed 0) takes 3 AdamW steps of
     ``make_train_step(shard_fn=make_shard_fn(plan))`` on ``place_params``
     weights (DTensors), every loss and grad norm within 1e-5 relative of
     the plain step's on the same weights and batches, no kernel launched;
     then ``reshard_params`` onto a fresh (1, 1) mesh gives the same bits.
     Host ms, CUDA-event ms and peak GB of both, beside phase 13's. (b)
     ``launch.dryrun.run_cell`` in three subprocesses at once (the
     ``fake`` group is process-global), on fake CUDA tensors:
     granite-3-8b ``train_4k`` on the 256-rank mesh, grok-1-314b
     ``train_4k`` on the 512-rank mesh with expert sharding over data (both
     at full depth, ``grad_accum`` 1: the reference's sizing traced too
     long for the phase), and
     (a)'s configuration on ``1x1:data,model``, whose predicted peak is
     printed beside (a)'s measured ``max_memory_allocated``; each cell's
     peak GB a device, flops a device and collective MiB. A cell that
     fails fails the phase. (c) On (a)'s mesh, granite-3-8b at full width
     cut to 1 layer (4.8 GB of f32 params and moments): the DTensor train
     state after step 2 saved by ``checkpoint.save_checkpoint`` (each leaf
     gathered whole) and restored by ``restore_latest``, re-placed with
     ``place_params``; its step 3's loss and grad norm equal to the
     uninterrupted step 3's bit for bit; the save's and the restore's host
     ms and the checkpoint's bytes beside the card's name and power limit;
     within 30 s.

The line before the last is the JSON table of kernels (launches from the
control loop of phase 6: granite's for the attention kernels and
gcn_layer, mamba2's for ssd_scan; gcn_layer_bwd's from the experiment of
phase 11, where gcn_layer's are given too, with its times at the DDPG
update's shapes under ``update``; the attention kernels' ``moe`` entries
give their times at the MoE heads and their launches on the MoE paths,
their ``vlm`` and ``audio`` entries those of phase 12, their ``fleet``
and ``mesh`` entries those of phase 14 -- (e)'s under ``mesh``'s
``replicated_axis`` -- and every serving kernel's
``model_axis`` entry its launches on phase 14(d)'s split path and its
parity and times at a model device's shapes); the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
import types
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOLS = {"float32": dict(atol=2e-5, rtol=2e-5),
        "bfloat16": dict(atol=3e-2, rtol=3e-2)}
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12       # dense bf16 tensor-core peak, same source
F32_FLOPS_PER_S = 67e12         # f32 outside the tensor cores, same source
TF32_FLOPS_PER_S = 495e12       # dense TF32 tensor-core peak, same source
N_REQUESTS, MAX_PROMPT, MAX_NEW = 16, 512, 64
MAX_BATCH, MAX_SEQ, REPLICAS, SEED = 8, 1024, 2, 0
# full-width bf16, kernel path vs einsum path: the einsum path rounds the
# softmax probabilities to bf16 before P.V and the kernel keeps them in
# f32, and each of the 40 layers rounds its activations to bf16 again, so
# the two agree to a few bf16 steps of the logits' scale, not bitwise
BF16_PATH_TOL = 0.05            # max |delta logits| / max |logits|
# the same in f32 at 2 layers: the paths differ only in the order of the
# attention sums, a few f32 ulps carried through two layers and the head
F32_PATH_TOL = 1e-4

KERNELS = {
    "flash_decode": dict(source="src/repro_torch/csrc/flash_decode.cu",
                         replaces="src/repro/kernels/decode_attention.py:27"),
    "flash_attention": dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:29"),
    "gcn_layer": dict(source="src/repro_torch/csrc/gcn_layer.cu",
                      replaces="src/repro/kernels/gcn_fused.py:17"),
    "ssd_scan": dict(source="src/repro_torch/csrc/ssd_scan.cu",
                     replaces="src/repro/kernels/ssd_scan.py:24"),
    # no Pallas counterpart: the reference's decode step is plain jnp
    # (src/repro/models/ssd.py ssd_decode_step)
    "ssd_decode": dict(source="src/repro_torch/csrc/ssd_decode.cu",
                       replaces=None),
    # no Pallas counterpart: the reference differentiates its plain XLA
    # GCN (src/repro/core/gcn.py:52 under jax.value_and_grad, from
    # src/repro/core/ddpg.py:141); this backward belongs to the same
    # Pallas kernel's layer
    "gcn_layer_bwd": dict(source="src/repro_torch/csrc/gcn_layer.cu",
                          replaces="src/repro/kernels/gcn_fused.py:17"),
}
# the ssm/hybrid family, served at full width after granite-3-8b, then
# mistral-nemo-12b (dense, a query width of 4096 against d_model 5120)
SSM_ARCHS = ("mamba2-1.3b", "zamba2-2.7b")
SERVED = ("granite-3-8b",) + SSM_ARCHS + ("mistral-nemo-12b",)
BLOCK = 4                       # --decode-block of the fused-window runs
# the federation run of mistral-nemo-12b: two cells under the hierarchy,
# cell 0 blacked out for 15 ticks
CELL_FLAGS = ["--cells", "2", "--hierarchy", "--cell-chaos",
              "cell_down@15:c0,cell_up@30:c0"]
SSD_TOL = dict(atol=1e-4, rtol=1e-4)  # tests/test_kernels.py's tolerance
SSD_OPS_BLOCK = 64    # the block of _time_ssd's operation count (PR 13's)
SSD_PASSES = 3        # its products: split TF32, three tensor-core passes
# (B, T) of the parity cases: the drain mode's bucket (8 x 512), ragged
# last blocks (96, 200, 24), the control loop's fleet prefills (K x 8 or
# 16); each runs at both heads-a-block choices, so both tiles' four
# instantiations (with the archs' two state sizes) all run
SSD_CASES = ((8, 512), (2, 96), (8, 200), (1, 8), (4, 16), (8, 16), (2, 24),
             (8, 24))
# attention head layouts (G kv heads, qpg q heads a group, head dim) at
# full width: granite-3-8b's and mistral-nemo-12b's layers, zamba2-2.7b's
# shared block, command-r-35b's layers (64 q / 8 kv, qpg 8; not served),
# grok-1-314b's (48 / 8, qpg 6) and llama4-maverick's (40 / 8, qpg 5):
# neither divides the bf16 attention body's 64 rows, so their q tiles end
# in padding rows
HEAD_LAYOUTS = ((8, 4, 128), (32, 1, 80), (8, 8, 128), (8, 6, 128),
                (8, 5, 128))
GCN_TOL = dict(atol=1e-5, rtol=1e-5)  # tests/test_kernels.py's tolerance
# (N, F, H): the serve path's two layers (2 nodes, horizon 8, gcn_hidden
# 64), the paper's 16-node cluster (horizon 32), the reference's sweep, and
# a few hundred nodes with F, H past one tile
GCN_SHAPES = [(2, 12, 64), (2, 64, 64), (16, 36, 64), (16, 64, 64),
              (8, 12, 16), (32, 8, 8), (256, 76, 128)]
CONTROL_MAX_SEQ = 256
CONTROL_FLAGS = ["--policy", "ours", "--autoscale", "gpso", "--nodes", "2",
                 "--replicas", "1", "--max-replicas", "4",
                 "--provision-delay", "3", "--ticks", "40", "--rate", "2",
                 "--max-batch", "8", "--max-seq", str(CONTROL_MAX_SEQ),
                 "--seed", str(SEED), "--device", "cuda"]
# the control loop's requests: prompts of 2-11 tokens and 4-11 new tokens
# (``run_control_loop``'s request factory), so no cache row passes depth 22
CONTROL_DEPTH = (2, 22)
# the MoE family at full width with its depth cut to fit one card's 80 GB
# in bf16 (widths, heads, experts, top-k and capacity factor are the
# published configs'): grok-1-314b's 64 layers to 4 (an expert stack of
# 8 x 3 x 6144 x 32768 = 4.83 G parameters, 9.66 GB, and 88 M of
# attention a layer; embed and head 2 x 131072 x 6144, 3.2 GB: 42.6 GB),
# llama4-maverick-400b-a17b's 48 layers to one layer group (an MoE layer
# of 128 experts x 3 x 5120 x 8192 = 32.2 GB with its shared expert, then
# a dense layer; embed and head 2 x 202048 x 5120, 4.1 GB: about 37 GB)
MOE_DEPTH = {"grok-1-314b": 4, "llama4-maverick-400b-a17b": 2}
MOE_ARCHS = tuple(MOE_DEPTH)
# grok's kernel-vs-einsum gate in f32 at 1 layer (about 26 GB): one
# layer's attention differs between the paths by f32 rounding only, far
# below any router margin, so every token routes alike and the gate is
# F32_PATH_TOL over all rows
MOE_F32_DEPTH = 1


CARD = ""    # the card's name and power limit, as nvidia-smi prints them


def log(msg: str) -> None:
    print(msg, flush=True)


def _free(torch) -> None:
    """Give the card back what finished runs held: a frontend and its fleet
    groups reference each other, so their caches and slabs go only with a
    collection, then the allocator's cache."""
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 1-3
def phase_card(torch) -> str:
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
    return smi


def phase_build(build) -> None:
    t0 = time.perf_counter()
    built = build.build()
    log(f"[build] {len(built)} kernels in {time.perf_counter() - t0:.1f}s")
    for b in built.values():
        log(f"[build] {b.name}: {b.path} ({b.seconds:.1f}s nvcc)")
        for line in b.log.splitlines():
            if "Compiling entry function" in line:
                log(f"[build]   {_kernel_name(line)}")
            elif "registers" in line or "spill" in line or "warning" in line:
                log(f"[build]     {line.strip()}")


def _kernel_name(ptxas_line: str) -> str:
    """The instantiation a ptxas 'Compiling entry function' line names,
    demangled when c++filt is there."""
    mangled = ptxas_line.split("'")[1] if "'" in ptxas_line else ptxas_line
    try:
        name = subprocess.run(["c++filt", mangled], capture_output=True,
                              text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return mangled
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name.removeprefix("void ")


def _close(name, got, want, dtype, torch) -> float:
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **TOLS[dtype],
                               msg=lambda m: f"{name} {dtype}: {m}")
    return err


def _ragged_pos(torch, gen, n: int, lo: int, hi: int):
    """``n`` cache depths in [lo, hi], the first two pinned to the ends."""
    pos = torch.randint(lo, hi + 1, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    pos[:2] = torch.tensor([lo, hi], dtype=torch.int32, device="cuda")
    return pos


def phase_parity(torch, ops, ref) -> dict:
    """Each kernel against its plain version on the same card inputs, at
    the drain mode's shapes and at the control loop's, for every served
    architecture."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {"flash_decode": 0.0, "flash_attention": 0.0}
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    # flash_decode: a long pool (8 slots x 4096: 32 chunks of the kernel's
    # 128), the control loop's fleet slab (up to 32 rows x max_seq 256),
    # ragged pos -- 0, S - 1, depths that are exact multiples of the chunk
    # (128, 2048) and one past one (129)
    pos_drain = torch.tensor([0, 4095, 127, 128, 2047, 777, 3000, 64],
                             dtype=torch.int32, device="cuda")
    decode_cases = [(8, 4096, pos_drain)] + [
        (rows, CONTROL_MAX_SEQ, _ragged_pos(torch, gen, rows, 0,
                                            CONTROL_MAX_SEQ - 1))
        for rows in (16, 32)]
    # flash_attention: ragged and long S (drain mode, causal and full), and
    # the control loop's fleet prefill (K prompts of one pow2 bucket sb)
    attn_cases = [(2, S, causal) for S in (1, 4, 8, 100, 2048)
                  for causal in (True, False)] + \
        [(K, sb, True) for K in (1, 2, 4, 8) for sb in (4, 8, 16)]
    for G, qpg, hd in HEAD_LAYOUTS:
        for B, S, pos in decode_cases:
            for dname, dt in dtypes.items():
                q = torch.randn(B, G, qpg, hd, generator=gen,
                                device="cuda").to(dt)
                k = torch.randn(B, S, G, hd, generator=gen,
                                device="cuda").to(dt)
                v = torch.randn(B, S, G, hd, generator=gen,
                                device="cuda").to(dt)
                got = ops.flash_decode(q, k, v, pos)
                torch.cuda.synchronize()
                err = _close("flash_decode", got,
                             ref.flash_decode_ref(q, k, v, pos), dname, torch)
                errs["flash_decode"] = max(errs["flash_decode"], err)
                # a row's result must not depend on the batch around it
                r = B // 2
                alone = ops.flash_decode(q[r:r + 1], k[r:r + 1], v[r:r + 1],
                                         pos[r:r + 1])
                if not torch.equal(alone, got[r:r + 1]):
                    raise AssertionError(f"flash_decode row {r} alone differs "
                                         f"from the same row in a batch of {B}")
                log(f"[parity] flash_decode B={B} Hq={G * qpg} Hkv={G} "
                    f"hd={hd} S={S} pos={pos.tolist()} {dname}: "
                    f"max|err|={err:.3e} (atol/rtol {TOLS[dname]['atol']}); "
                    f"row {r} alone == in batch")
        for B, S, causal in attn_cases:
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
    errs["gcn_layer"] = phase_parity_gcn(torch, ops, ref, gen)
    errs["ssd_scan"] = phase_parity_ssd(torch, ops, ref, gen)
    return errs


def _ssd_inputs(torch, gen, B, T, H, P, N, lengths=None):
    """SSD scan inputs in the model's range: dt in [1e-3, 1e-1] (0 on the
    steps past each row's ``lengths``, as a bucketed prefill pads), A in
    [-16, -1] (mamba2's init), x ~ N(0, 1) weighted by dt, B and C ~
    N(0, 1). Returns contiguous f32 (x * dt, dt * A, B, C)."""
    import math
    dt = torch.empty(B, T, H, device="cuda").uniform_(
        math.log(1e-3), math.log(1e-1), generator=gen).exp()
    if lengths is not None:
        t = torch.arange(T, device="cuda")
        dt = torch.where(t[None, :, None] < lengths[:, None, None], dt, 0.0)
    A = -torch.empty(H, device="cuda").uniform_(1.0, 16.0, generator=gen)
    x = torch.randn(B, T, H, P, generator=gen, device="cuda") * dt[..., None]
    bm = torch.randn(B, T, N, generator=gen, device="cuda")
    cm = torch.randn(B, T, N, generator=gen, device="cuda")
    return x.contiguous(), (dt * A).contiguous(), bm, cm


def phase_parity_ssd(torch, ops, ref, gen) -> float:
    """ssd_scan against its plain version, f32, for both ssm archs' heads
    (mamba2 H 64 P 64 N 128, zamba2 H 80 P 64 N 64) at ``SSD_CASES``, with
    ragged lengths (dt 0 past them), at the model's chunk: the launcher's
    own (tile, hpb) through ``ops.ssd_scan``, and the other hpb at that
    tile forced, so that each arch runs every instantiation whichever the
    plan picks on this card. Each instantiation's dynamic shared memory and
    blocks per SM at the arch's N are printed."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as ssd

    worst = 0.0
    for name in SSM_ARCHS:
        cfg = get_config(name)
        H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        reached = set()
        for B, T in SSD_CASES:
            tile, hpb = ssd.device_plan(B, T, H, N, "cuda")
            lengths = torch.randint(1, T + 1, (B,), generator=gen,
                                    device="cuda")
            lengths[0] = T
            lengths[-1] = 1 if B > 1 else T
            x, a, bm, cm = _ssd_inputs(torch, gen, B, T, H, P, N, lengths)
            chunk = min(cfg.ssm_chunk, T)
            y_ref, st_ref = ref.ssd_scan_ref(x, a, bm, cm, chunk)
            errs = {}
            for h in range(1, ssd.MAX_HPB + 1):
                if h == hpb:
                    y, st = ops.ssd_scan(x, a, bm, cm, chunk=chunk)
                else:
                    y, st = torch.empty_like(x), torch.empty_like(st_ref)
                    ssd.launch(x, a, bm, cm, y, st, instantiation=(tile, h))
                torch.cuda.synchronize()
                for got, want in ((y, y_ref), (st, st_ref)):
                    torch.testing.assert_close(
                        got, want, **SSD_TOL,
                        msg=lambda m: f"ssd_scan {name} ({B}, {T}) tile "
                        f"{tile} hpb {h}: {m}")
                errs[h] = max((y - y_ref).abs().max().item(),
                              (st - st_ref).abs().max().item())
                reached.add((tile, h))
            worst = max(worst, *errs.values())
            log(f"[parity] ssd_scan {name} B={B} T={T} H={H} P={P} N={N} "
                f"chunk={chunk} tile={tile} lengths={lengths.tolist()} f32: "
                "max|err| " + ", ".join(
                    f"hpb {h} {e:.3e}{' (plan)' if h == hpb else ''}"
                    for h, e in errs.items())
                + f" (atol/rtol {SSD_TOL['atol']}; |y| max "
                f"{y_ref.abs().max().item():.3e})")
        every = {(q, h) for q in ssd.TILES for h in range(1, ssd.MAX_HPB + 1)}
        if reached != every:
            raise AssertionError(f"ssd_scan {name}: parity cases reach "
                                 f"{sorted(reached)}, not {sorted(every)}")
        log(f"[parity] ssd_scan {name} instantiations (tile, hpb): "
            + ", ".join(f"({q}, {h}) {ssd.smem_bytes(q, h, N)} B shared, "
                        f"{ssd.blocks_per_sm(q, h, N, 0)} blocks an SM"
                        for q, h in sorted(every)))
    return worst


# (mamba2-1.3b rows) of ssd_decode's parity and times: the rag cell's
# decode dispatches (a group's slab of 2 to 4 replicas of 32 or 64 slots)
# and its whole fleet of 384 rows; zamba2-2.7b at the first
SSD_DECODE_ROWS = (128, 192, 256, 384)
SSD_DECODE_ROW = 256        # the JSON row's
SSD_DECODE_LAYERS = 4       # layer states a timing walks, none left in L2


def _decode_bytes(B, H, P, N, written) -> int:
    """Bytes of one ssd_decode launch: each state row read once and each
    written row written once (f32), x, B and C in (bf16), dt in and y out
    (f32), A and the write buffer."""
    return (4 * (B + written) * H * P * N + 2 * B * (H * P + 2 * N)
            + 4 * B * H + 4 * B * H * P + 4 * H + 4 * B)


def phase_ssd_decode(torch, ops, ref) -> tuple:
    """ssd_decode against its plain version, then timed: mamba2-1.3b's
    heads (64 x 64, N 128) at ``SSD_DECODE_ROWS`` rows and zamba2-2.7b's
    (80 x 64, N 64) at 128, x, B and C in bf16 as views of one buffer
    (the model's layout) and the state in f32, every row written and 3 in
    4 (the write buffer padded to B by repeating it, as the fleet stages
    it). The written state must equal the plain version's bit for bit and
    y lie within ``SSD_TOL``. Times: CUDA-event medians over graph replays
    of one launch a layer state over ``SSD_DECODE_LAYERS`` states; the
    bound is bytes (``_decode_bytes``) at 3.35 TB/s. Returns (worst y
    error, the JSON row: mamba2-1.3b at ``SSD_DECODE_ROW`` rows, 3 in 4
    written)."""
    from repro_torch.configs import get_config

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    worst, row = 0.0, None
    cases = [(SSM_ARCHS[0], B) for B in SSD_DECODE_ROWS] + \
        [(SSM_ARCHS[1], SSD_DECODE_ROWS[0])]
    for name, B in cases:
        cfg = get_config(name)
        H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        L = SSD_DECODE_LAYERS
        states = torch.randn(L, B, H, P, N, generator=gen, device="cuda")
        xbc = torch.randn(B, H * P + 2 * N, generator=gen,
                          device="cuda").to(torch.bfloat16)
        x = xbc[:, :H * P].reshape(B, H, P)
        bm = xbc[:, H * P:H * P + N].reshape(B, 1, N)
        cm = xbc[:, H * P + N:].reshape(B, 1, N)
        dt = torch.empty(B, H, device="cuda").uniform_(
            math.log(1e-3), math.log(1e-1), generator=gen).exp()
        A = -torch.empty(H, device="cuda").uniform_(1.0, 16.0, generator=gen)
        written = [r for r in range(B) if r % 4]
        padded = (written * 2)[:B]
        for label, rows, n_w in (
                ("every row", None, B),
                ("3 in 4 rows", torch.tensor(padded, dtype=torch.int32,
                                             device="cuda"), len(written))):
            before = states[0].clone()
            want = before.clone()
            y_want = ref.ssd_decode_ref(want, x, dt, A, bm, cm, rows)
            y = ops.ssd_decode(states[0], x, dt, A, bm, cm, write=rows)
            torch.cuda.synchronize()
            if not torch.equal(states[0], want):
                raise AssertionError(
                    f"ssd_decode {name} B={B} {label}: "
                    f"{(states[0] != want).sum().item()} state values differ "
                    "from the plain version's")
            if rows is not None and not torch.equal(states[0][0::4],
                                                    before[0::4]):
                raise AssertionError(f"ssd_decode {name} B={B}: an unwritten "
                                     "row changed")
            torch.testing.assert_close(
                y, y_want, **SSD_TOL,
                msg=lambda m: f"ssd_decode {name} B={B} {label}: {m}")
            err = (y - y_want).abs().max().item()
            worst = max(worst, err)
            ms = _graph_ms(torch, lambda: [
                ops.ssd_decode(states[i], x, dt, A, bm, cm, write=rows)
                for i in range(L)], L)
            plain = _graph_ms(torch, lambda: [
                ref.ssd_decode_ref(states[i], x, dt, A, bm, cm, rows)
                for i in range(L)], L)
            nbytes = _decode_bytes(B, H, P, N, n_w)
            bound, by = _bound(nbytes, 5.0 * B * H * P * N, F32_FLOPS_PER_S)
            log(f"[ssd_decode] {name} B={B} H={H} P={P} N={N} {label}: "
                f"state bit for bit, max|y err| {err:.3e} (atol/rtol "
                f"{SSD_TOL['atol']}); kernel {ms:.4f} ms "
                f"({nbytes / ms / 1e6:.0f} GB/s, {100 * bound / ms:.1f}% of "
                f"the bound), plain {plain:.4f} ms, library none, bound "
                f"{bound:.4f} ms ({by}: {nbytes} B)")
            if (name, B) == (SSM_ARCHS[0], SSD_DECODE_ROW) and n_w < B:
                row = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                           library_ms=None, timed_at=(
                               f"{name} B={B}, 3 in 4 rows written, "
                               f"{L} layer states"))
        del states, xbc
        _free(torch)
    return worst, row


def _gcn_inputs(torch, gen, xs, ws):
    """Inputs in the range the balancer gives the kernel: a row-normalised
    adjacency (entries in [0, 1], rows summing to 1, like D^-1/2 (A+I)
    D^-1/2), unit-normal features and he-scaled weights, so outputs are
    O(1) and the reference's absolute 1e-5 is a fair bound (with raw
    uniform adjacency rows summing to N/2 the outputs reach ~1e3 and any
    other summation order misses 1e-5 near zero)."""
    n = xs[-2]
    a = torch.rand(n, n, generator=gen, device="cuda")
    a = a / a.sum(dim=1, keepdim=True)
    x = torch.randn(*xs, generator=gen, device="cuda")
    w = torch.randn(*ws, generator=gen, device="cuda") / ws[0] ** 0.5
    b = 0.1 * torch.randn(ws[1], generator=gen, device="cuda")
    return a, x, w, b


def _actor_inputs(torch, gen, n, f, lead=(), mask="all_up", noise=False):
    """The balancer's action inputs on the card: the topology's normalised
    adjacency over ``n`` nodes, obs (lead, n, f) ~ N(0, 1), an actor of the
    paper's widths (2 GCN layers of 64, a head of 128) with he-scaled
    weights and biases ~ 0.1 N(0, 1) -- the head's last layer at full
    scale, so the logits differ by O(1) and the softmax is far from uniform
    -- and the up-mask: every node up ("all_up"), node 0 down ("one_down"),
    ~40% down per observation ("rows"), or none up ("all_down"); noise ~
    N(0, 1)."""
    import numpy as np

    from repro_torch.configs.paper_cluster import ClusterConfig
    from repro_torch.core.gcn import make_topology, normalize_adjacency

    cfg = ClusterConfig()
    a = torch.from_numpy(normalize_adjacency(make_topology(
        n, cfg.topology)).astype(np.float32)).cuda()

    def he(i, o):
        return torch.randn(i, o, generator=gen, device="cuda") / i ** 0.5

    def bias(o):
        return 0.1 * torch.randn(o, generator=gen, device="cuda")
    h, hid = cfg.gcn_hidden, cfg.actor_hidden
    dims = [f] + [h] * cfg.gcn_layers
    gcn = {"w": [he(dims[i], dims[i + 1]) for i in range(len(dims) - 1)],
           "b": [bias(d) for d in dims[1:]]}
    head = {"w1": he(h + f, hid), "b1": bias(hid), "w2": he(hid, 1),
            "b2": bias(1)}
    obs = torch.randn(*lead, n, f, generator=gen, device="cuda")
    up = torch.ones(*lead, n, device="cuda")
    if mask == "one_down":
        up[..., 0] = 0.0
    elif mask == "rows":
        up = (torch.rand(*lead, n, generator=gen, device="cuda")
              > 0.4).float()
    elif mask == "all_down":
        up.zero_()
    nz = torch.randn(*lead, n, generator=gen, device="cuda") if noise \
        else None
    return a, obs, gcn, head, up, nz


def phase_parity_actor(torch, ops, ref, gen) -> float:
    """The balancer's whole action, one gcn_actor launch, against its
    plain version, f32: the serve defaults (2 nodes, F 12), the paper's
    cluster (16, F 36), a masked node with noise, a batch of observations
    with their own masks, every node down (the uniform split), and the
    largest graph that ``gcn_actor_fits`` admits. One node above it the
    action runs layered (``ddpg.actor_action(..., fused=False)``): two
    gcn_layer launches and the eager head, held to the same plain
    version."""
    from repro_torch.core import ddpg

    worst = 0.0
    n_max = max(n for n in range(1, 1024) if ops.gcn_actor_fits(n, 12, 64,
                                                                 128))
    cases = [(2, 12, (), "all_up", False), (16, 36, (), "all_up", False),
             (16, 36, (), "one_down", True), (5, 12, (3,), "rows", True),
             (2, 12, (), "all_down", True), (n_max, 12, (), "one_down", True),
             (n_max + 1, 12, (), "one_down", True)]
    for n, f, lead, mask, noise in cases:
        a, obs, gcn, head, up, nz = _actor_inputs(torch, gen, n, f, lead,
                                                  mask, noise)
        actor = {"gcn": gcn, "head": head}
        fused = ddpg.actor_fits(actor, n, f)
        before = ops.LAUNCHES["gcn_layer"]
        got = ddpg.actor_action(actor, a, obs, up_mask=up, noise=nz,
                                fused=fused)
        torch.cuda.synchronize()
        launches = ops.LAUNCHES["gcn_layer"] - before
        want = ref.gcn_actor_ref(a, obs, gcn, head, up_mask=up, noise=nz)
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, **GCN_TOL,
                                   msg=lambda m: f"gcn_actor {n} {f}: {m}")
        if launches != (1 if fused else len(gcn["w"])) \
                or fused != (n <= n_max):
            raise AssertionError(f"gcn_actor N={n}: fused {fused}, "
                                 f"{launches} launches")
        worst = max(worst, err)
        log(f"[parity] gcn_actor N={n} F={f} lead={lead} mask={mask} "
            f"noise={noise} f32: {'fused, 1 launch' if fused else 'layered'}"
            f"{'' if fused else f', {launches} gcn_layer launches'}; "
            f"max|err|={err:.3e} (atol/rtol {GCN_TOL['atol']}); fractions "
            f"max {want.max().item():.3f} min {want.min().item():.3e}")
    return worst


def phase_parity_gcn(torch, ops, ref, gen) -> float:
    """gcn_layer against its plain version, f32, relu on and off, at the
    control plane's shapes and beyond, plus one batched case; then the
    whole action (``phase_parity_actor``)."""
    worst = phase_parity_actor(torch, ops, ref, gen)
    cases = [((n, f), (f, h), relu) for n, f, h in GCN_SHAPES
             for relu in (True, False)] + [((4, 16, 36), (36, 64), True)]
    for xs, ws, relu in cases:
        a, x, w, b = _gcn_inputs(torch, gen, xs, ws)
        got = ops.gcn_layer(a, x, w, b, relu=relu)
        torch.cuda.synchronize()
        want = ref.gcn_layer_ref(a, x, w, b, relu=relu)
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, **GCN_TOL,
                                   msg=lambda m: f"gcn_layer {xs}: {m}")
        worst = max(worst, err)
        log(f"[parity] gcn_layer x={xs} w={ws} relu={relu} f32: "
            f"max|err|={err:.3e} (atol/rtol {GCN_TOL['atol']})")
    return worst


# ------------------------------------------------------------------ phase 4
def _serve_args(serve, backend="pallas"):
    return serve.build_parser().parse_args(
        ["--policy", "lc", "--replicas", str(REPLICAS), "--max-batch",
         str(MAX_BATCH), "--max-seq", str(MAX_SEQ), "--requests",
         str(N_REQUESTS), "--seed", str(SEED), "--attn-backend", backend,
         "--device", "cuda"])


def _per_dispatch(cfg) -> dict:
    """Launches of each kernel per (prefill, decode) dispatch of ``cfg``'s
    model: the attention kernels once per attention layer (the hybrid's
    shared block once per invocation; the audio family's prefill once per
    encoder layer and twice per decoder layer, its decode twice per
    decoder layer), ssd_scan once per mamba layer in prefill and never in
    decode, ssd_decode once per mamba layer in decode. gcn_layer runs in
    the plane: once a tick (the balancer's whole action)."""
    from repro_torch.models.ssm_lm import n_invocations

    if cfg.family == "audio":   # encoder, decoder self and cross; decode:
        L = cfg.num_layers      # self and cross over the cached K/V
        return {"flash_decode": (0, 2 * L),
                "flash_attention": (cfg.encoder_layers + 2 * L, 0),
                "ssd_scan": (0, 0), "ssd_decode": (0, 0)}
    dense = cfg.family in ("dense", "moe", "vlm")  # attention LMs, no SSM
    attn = cfg.num_layers if dense else n_invocations(cfg)
    mamba = 0 if dense else cfg.num_layers
    return {"flash_decode": (0, attn), "flash_attention": (attn, 0),
            "ssd_scan": (mamba, 0), "ssd_decode": (0, mamba)}


def _check_launches(cfg, launches, prefill, decode, ticks=0,
                    heads=1) -> None:
    """The launch counts of one run against its dispatches; fails too when
    a kernel of the run's path was never launched. ``heads``: the devices
    of a fleet mesh's ``model`` axis, each running every kernel of a
    dispatch on its head block (phase 14(d))."""
    want = {k: heads * (p * prefill + d * decode)
            for k, (p, d) in _per_dispatch(cfg).items()}
    want["gcn_layer"] = ticks
    want["gcn_layer_bwd"] = 0         # the serve path never trains
    path = [k for k, (p, d) in _per_dispatch(cfg).items() if p or d]
    if ticks:
        path.append("gcn_layer")
    if launches != want or any(launches[k] == 0 for k in path):
        raise AssertionError(f"launches {launches} != expected {want} "
                             f"(path {path})")


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
    toks = sum(len(r.output) for r in fe.finished)
    log(f"[serve] {cfg.name}: launches {launches}; decode steps {steps}, "
        f"prefill dispatches {dispatches}, layers {cfg.num_layers}; prefill "
        f"shapes {shapes}; syncs {sum(r.syncs for r in reps)}, sync wait "
        f"{sum(r.sync_wait for r in reps):.3f}s; {len(fe.finished)} "
        f"requests, {toks} tokens in {wall:.2f}s: {toks / wall:.1f} tok/s")
    if len(fe.finished) != N_REQUESTS or not all(r.done
                                                 for r in fe.finished):
        raise AssertionError(f"{len(fe.finished)}/{N_REQUESTS} finished")
    _check_launches(cfg, launches, dispatches, steps)  # drain: no plane
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


def phase_paths(torch, cfg, model, params, workload, small):
    """Kernel path vs einsum path on the card."""
    batch = _bucket([w["prompt"] for w in workload[:MAX_BATCH]], "cuda",
                    torch)
    checks = [("bf16", params, torch.bfloat16, BF16_PATH_TOL)]
    if cfg.family != "dense":
        # each layer's two scans agree to f32 rounding (~1e-5), but every
        # bf16 layer rounds its output to bf16, and 48-54 random residual
        # layers amplify those one-step flips to ~5-9% of the logits' scale
        # (PERF.md): the gate for this family is full depth in f32, where
        # only the kernel differs; bf16 is reported
        checks = [("f32", model.init(seed=SEED, dtype=torch.float32,
                                     device="cuda"), torch.float32,
                   F32_PATH_TOL), ("bf16", params, torch.bfloat16, None)]
    for label, p, dt, tol in checks:
        out = {}
        tok = None
        # both paths decode the token the einsum path's prefill chose, so
        # the decode logits compare like with like even where a near-tie
        # of the prefill logits flips an argmax within the tolerance
        for backend in ("einsum", "pallas"):
            logits, cache, pos = model.prefill(
                p, batch, cache_len=MAX_SEQ, cache_dtype=dt,
                attn_backend=backend)
            if tok is None:
                tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            dlogits, _ = model.decode(p, cache, tok, pos,
                                      attn_backend=backend)
            out[backend] = (logits.float(), dlogits.float())
            del cache
        for i, what in enumerate(("prefill last-token", "first decode")):
            k, e = out["pallas"][i], out["einsum"][i]
            rel = ((k - e).abs().max() / e.abs().max()).item()
            flip = k.argmax(-1) != e.argmax(-1)
            top2 = e.topk(2, dim=-1).values
            margins = ((top2[:, 0] - top2[:, 1])[flip] / e.abs().max())
            log(f"[paths] {cfg.name} {label} full width {what} logits: "
                f"max|kernel-einsum| / max|einsum| = {rel:.3e} (tolerance "
                f"{tol if tol is not None else 'none: reported'}); argmax "
                f"agreement {1 - flip.float().mean().item():.3f}"
                + (f", flipped rows' einsum top-2 margin / max|einsum| "
                   f"{[round(m, 5) for m in margins.tolist()]}"
                   if flip.any() else ""))
            if tol is not None and not rel <= tol:
                raise AssertionError(f"{what} logits differ by {rel:.3e}")
    del checks, out
    torch.cuda.empty_cache()
    phase_streams(torch, cfg, small, workload)


def phase_streams(torch, cfg, small, workload) -> None:
    """f32, full width, depth cut (``small``): identical greedy streams
    through the whole drain-mode path, kernel against einsum, and the
    replicas' graph-replayed steps against eager ones."""
    from repro_torch.launch import serve

    cfg2, model2, params2 = small
    streams = {}
    for name, backend, graph in (("pallas", "pallas", True),
                                 ("einsum", "einsum", True),
                                 ("eager", "pallas", False)):
        fe, _, _ = serve.run_drain_mode(_serve_args(serve, backend), cfg2,
                                        model2, params2,
                                        cache_dtype=torch.float32,
                                        workload=workload, decode_graph=graph)
        streams[name] = sorted((r.rid, tuple(r.output), r.first_token_time,
                                r.finish_time) for r in fe.finished)
    same = streams["pallas"] == streams["einsum"]
    eager = streams["pallas"] == streams["eager"]
    n_tok = sum(len(s[1]) for s in streams["pallas"])
    log(f"[paths] {cfg.name} f32 full width, {cfg2.num_layers} layers: "
        f"{len(streams['pallas'])} "
        f"requests, {n_tok} tokens, streams identical: {same}; graph-"
        f"replayed steps against eager ones identical: {eager}")
    if not (same and eager):
        raise AssertionError("f32 greedy streams differ between kernel and "
                             "einsum paths or graph and eager steps")


# ------------------------------------------------------------------ phase 6
# the only operation of the port allowed to synchronise with the card in
# the async control loop: the plane's fetch of its own stream's fractions
# and GPSO plan (the engine's one wait a tick is an event wait)
PLANE_FETCHES = "src/repro_torch/control/plane.py"


def _where(filename: str) -> str:
    path = Path(filename).resolve()
    return str(path.relative_to(ROOT)) if path.is_relative_to(ROOT) \
        else path.name


def _admit_fetch_lines() -> set:
    """The ``file:line`` keys of ``engine._timed_get``: the eager fetch of
    an exact-length admit's first token (the reference's single-admit
    path, which the MoE family takes: one blocking sync an admit, counted
    as the replica's own, ``replica_syncs``)."""
    import inspect

    from repro_torch.serving import engine

    lines, start = inspect.getsourcelines(engine._timed_get)
    path = _where(inspect.getsourcefile(engine._timed_get))
    return {f"{path}:{start + i}" for i in range(len(lines))}


def _control_args(serve, *extra):
    return serve.build_parser().parse_args(CONTROL_FLAGS + list(extra))


def _digest(fe) -> list:
    return sorted((r.rid, tuple(r.output), r.first_token_time, r.finish_time)
                  for r in fe.finished)


def phase_control(torch, ops, cfg, model, params, plan_times=False,
                  mesh=None) -> dict:
    """The main path, counted: the control loop at full width, its decode
    dispatches replaying captured CUDA graphs; with ``mesh``, every fleet
    group's slab split over its shards (phase 14(b)), and each replica's
    heads over its ``model`` axis (phase 14(d))."""
    from repro_torch.launch import serve

    from repro_torch.serving.elastic import async_tick_violations

    args = _control_args(serve)
    torch.cuda.synchronize()
    ops.reset_launches()
    # every operation that synchronises the host with the card is flagged
    # (torch's sync debug mode): the async tick may have none in the engine,
    # only the plane's fetches of its own stream's results
    out, flagged = _sync_checked(torch, lambda: serve.run_control_loop(
        args, cfg, model, params, cache_dtype=torch.bfloat16, mesh=mesh))
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    fe, plane, ticks = out["fe"], out["plane"], out["ticks"]
    # exact-length admits (the moe family) fetch their first token eagerly,
    # as the reference's do: allowed only in a run that made them
    singles = sum(t["replica_syncs"] for t in ticks)
    admits = _admit_fetch_lines() if singles else set()
    log(f"[control] synchronising operations flagged in the run: "
        f"{dict(flagged)}; exact-length admits' own syncs {singles}")
    hidden = {k: n for k, n in flagged.items()
              if k.startswith("src/repro_torch/")
              and not k.startswith(PLANE_FETCHES) and k not in admits}
    if hidden:
        raise AssertionError(f"host syncs besides the plane's fetches and "
                             f"the exact-length admits': {hidden}")
    L = cfg.num_layers
    decode, prefill = fe.decode_steps(), fe.prefill_dispatches()
    syncs = fe.sync_count()
    toks = sum(len(r.output) for r in fe.finished)
    tick_ms = sorted(t["s"] * 1e3 for t in ticks)
    busy = sum(1 for t in ticks if t["decode_dispatches"]
               or t["prefill_dispatches"])
    hs = {k: v / len(ticks) * 1e3 for k, v in plane.host_s.items()}
    log(f"[control] {cfg.name}: launches {launches}; plane ticks "
        f"{len(ticks)}, decode "
        f"dispatches {decode}, prefill dispatches {prefill}, layers {L}; "
        f"syncs {syncs} over {busy} ticks with work (+ drain); replicas "
        f"spawned {fe.replicas_spawned}; peak slab rows "
        f"{fe.peak_slab_rows()}; fleet prefill shapes "
        f"{sorted(fe.prefill_shapes())}")
    log(f"[control] {len(fe.finished)} requests, {toks} tokens in "
        f"{out['wall']:.2f}s: {toks / out['wall']:.1f} tok/s; tick wall ms "
        f"p50 {statistics.median(tick_ms):.2f} p95 "
        f"{tick_ms[int(0.95 * (len(tick_ms) - 1))]:.2f}; engine sync wait "
        f"{fe.sync_wait_s():.3f}s; plane host ms/tick forecast "
        f"{hs['forecast']:.2f} balance {hs['balance']:.2f} (actor "
        f"{plane.rl.actor}) scale {hs['scale']:.2f}; plane fetches "
        f"{plane.fetches}, fetch wait {plane.fetch_wait:.3f}s")
    led = fe.ledger
    if not (led.balanced() and len(fe.finished) == led.submitted
            and all(r.done for r in fe.finished)):
        raise AssertionError(f"ledger {led.balance()}")
    if fe.replicas_spawned <= args.nodes * args.replicas:
        raise AssertionError("GPSO never scaled up")
    # the launches follow from the dispatches as the shards ran them (the
    # dispatches themselves when unsharded)
    shard_runs = fe.shard_dispatches()
    heads = 1 if mesh is None else mesh.shape.get("model", 1)
    _check_launches(cfg, launches, *shard_runs, len(ticks), heads=heads)
    if mesh is None:
        _graph_report(torch, cfg, fe)
        _fleet_step_times(torch, model, params, fe.peak_slab_rows(),
                          args.max_seq)
    # the async tick's sync contract, tick by tick: each sync consumes one
    # fleet dispatch's results (the pool has two max_batch groups, and speed
    # 1.4 replicas take a second sub-step round on some ticks, so a tick may
    # pay several), and each tick leaves its last round in flight
    broken = async_tick_violations(ticks)
    per_tick = collections.Counter(t["syncs"] for t in ticks)
    log(f"[control] async tick: syncs per tick {dict(sorted(per_tick.items()))}"
        f"; ticks leaving dispatches in flight "
        f"{sum(t['in_flight_groups'] > 0 for t in ticks)}/{len(ticks)}; "
        f"churn flushes {sum(t['syncs'] - t['reconciles'] for t in ticks)}; "
        f"contract broken on {len(broken)} ticks")
    if broken:
        raise AssertionError(f"async tick sync contract: {broken}")
    if plan_times:
        _plan_times(plane)
    return {"launches": launches, "digest": _digest(fe),
            "rows": fe.peak_slab_rows(), "shapes": fe.prefill_shapes(),
            "balance_ms": hs["balance"], "syncs": syncs,
            "tok_s": toks / out["wall"], "tick_ms": tick_ms,
            "decode": decode, "prefill": prefill, "shard_runs": shard_runs,
            "per_tick": [(t["decode_dispatches"], t["prefill_dispatches"],
                          t["syncs"]) for t in ticks],
            "caps": sorted(g.cap for g in fe._fleets.values()),
            "peak_bytes": {g.max_batch: g.peak_bytes
                           for g in fe._fleets.values()},
            "graphs": fe.graph_stats(),
            "eager": any(p.graphs.eager for g in fe._fleets.values()
                         for p in g.parts),
            "wall": out["wall"]}


def _graph_report(torch, cfg, fe) -> dict:
    """The fleet groups' decode graphs after a control loop: captures,
    recaptures after a slab growth, replays and the graphs' pool memory;
    then the largest group's full dispatch through the engine's own path
    (graph replay, the pinned copy of its outputs, the reconcile's wait):
    host ms to enqueue, host ms to the results, device ms (CUDA events
    around the replay) and the dispatch's idle share."""
    from repro_torch.serving.engine import _Pending, _timed_wait

    groups = list(fe._fleets.values())
    g = max(groups, key=lambda g: g.cap * g.max_batch)
    pool = sum(x.graphs.pool_bytes() for x in groups)
    stats = fe.graph_stats()

    def dispatch():
        return g.graphs.run((False, 1),
                            lambda: g._micro_steps(g.parts[0], 1,
                                                   masked=False))

    dispatch()
    torch.cuda.synchronize()
    enq, done, dev = [], [], []
    for _ in range(11):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        outs = dispatch()
        b.record()
        pend = _Pending("decode", [((), outs)], [])
        t1 = time.perf_counter()
        _timed_wait(g, [pend])
        t2 = time.perf_counter()
        enq.append((t1 - t0) * 1e3)
        done.append((t2 - t0) * 1e3)
        dev.append(a.elapsed_time(b))
    host, device = statistics.median(done[1:]), statistics.median(dev[1:])
    log(f"[graphs] {cfg.name}: {stats}; graph pools "
        f"{pool / 2**20:.1f} MiB; fleet decode dispatch (graph replay), "
        f"{g.cap * g.max_batch} slab rows x {g.max_seq}: host "
        f"{statistics.median(enq[1:]):.3f} ms to enqueue, {host:.2f} ms to "
        f"the results, device busy {device:.2f} ms (CUDA events, medians "
        f"of 10): idle share {1 - device / host:.3f}")
    return {"rows": g.cap * g.max_batch, "host_ms": host,
            "device_ms": device, "idle": 1 - device / host}


def phase_balance_ab(torch, ops, cfg, model, params, control) -> None:
    """The plane's balance phase, host ms a tick, with the balancer's
    action fused (one gcn_actor launch) against layered (two gcn_layer
    launches and the eager head): the control loop of phase 6 again with
    the balancer forced layered, twice, then fused, so that with phase 6's
    run the order is fused, layered, layered, fused. The same weights (the
    seed's) on both paths; each run's launches a tick are checked, and its
    digest must equal phase 6's (the two paths' fractions differ by f32
    rounding only, and on this seed no routing decision is that close).
    Then the balance phase alone over larger graphs
    (``_balance_by_nodes``)."""
    from repro_torch.core import balancer as bal
    from repro_torch.launch import serve

    args = _control_args(serve)
    ccfg = serve.cluster_config(args)
    ms = {"fused": [control["balance_ms"]], "layered": []}
    for layered in (True, True, False):
        rl = bal.RLBalancer(ccfg, 4 + ccfg.horizon, seed=SEED,
                            device="cuda", layered=layered)
        torch.cuda.synchronize()
        ops.reset_launches()
        out = serve.run_control_loop(args, cfg, model, params,
                                     cache_dtype=torch.bfloat16, rl=rl)
        torch.cuda.synchronize()
        n = len(out["ticks"])
        per_tick = ops.LAUNCHES["gcn_layer"] / n
        if per_tick != (2 if layered else 1):
            raise AssertionError(f"{rl.actor}: {per_tick} gcn_layer "
                                 "launches a tick")
        if _digest(out["fe"]) != control["digest"]:
            raise AssertionError(f"control loop with the actor {rl.actor}: "
                                 "digest differs from phase 6's")
        ms[rl.actor].append(out["plane"].host_s["balance"] / n * 1e3)
        del out
    log(f"[control] {cfg.name} balance host ms a tick, fused / layered in "
        f"turns (fused, layered, layered, fused): "
        f"{ms['fused'][0]:.3f}, {ms['layered'][0]:.3f}, "
        f"{ms['layered'][1]:.3f}, {ms['fused'][1]:.3f}; means fused "
        f"{statistics.mean(ms['fused']):.3f} layered "
        f"{statistics.mean(ms['layered']):.3f}; gcn_layer launches a tick "
        f"fused 1, layered 2; digests equal to phase 6's")
    _balance_by_nodes(torch, ops, ccfg)


def _balance_by_nodes(torch, ops, ccfg, calls: int = 200) -> None:
    """The plane's balance phase alone (``ControlPlane._balance``: the two
    host-to-device copies, the action, the fetch of the fractions), host
    ms a call, fused against layered in turns (fused, layered, layered,
    fused) at graphs of 2, 16, 64, 128 and 144 nodes (the largest that one
    block holds at these widths), F as in the control loop. The
    ``RLBalancer`` picks fused by shared-memory fit alone; above ~64 nodes
    the one-block action is slower on the device than the layered chain,
    so this reads whether the host's saving still outweighs it."""
    import types

    import numpy as np

    from repro_torch.control.plane import ControlPlane
    from repro_torch.core import balancer as bal

    feat = 4 + ccfg.horizon
    rng = np.random.default_rng(SEED)
    for n in (2, 16, 64, 128, 144):
        cc = dataclasses.replace(ccfg, num_nodes=n)
        obs = rng.standard_normal((n, feat)).astype(np.float32)
        up = np.ones(n, np.float32)
        ms = {"fused": [], "layered": []}
        for layered in (False, True, True, False):
            rl = bal.RLBalancer(cc, feat, seed=SEED, device="cuda",
                                layered=layered)
            if rl.actor != ("layered" if layered else "fused"):
                raise AssertionError(f"N={n}: actor {rl.actor}")
            plane = ControlPlane(cc, types.SimpleNamespace(num_nodes=n),
                                 balancer="rl", rl=rl, device="cuda")
            for _ in range(10):
                plane._balance(obs, up, 1.0)
            ops.reset_launches()
            t0 = time.perf_counter()
            for _ in range(calls):
                fr = plane._balance(obs, up, 1.0)
            ms[rl.actor].append((time.perf_counter() - t0) / calls * 1e3)
            if ops.LAUNCHES["gcn_layer"] != calls * (2 if layered else 1) \
                    or abs(float(fr.sum()) - 1.0) > 1e-5:
                raise AssertionError(f"N={n} {rl.actor}: "
                                     f"{ops.LAUNCHES['gcn_layer']} launches, "
                                     f"fractions sum {fr.sum()}")
        log(f"[control] balance phase alone N={n} F={feat}, host ms a call "
            f"({calls} calls) in turns (fused, layered, layered, fused): "
            f"{ms['fused'][0]:.4f}, {ms['layered'][0]:.4f}, "
            f"{ms['layered'][1]:.4f}, {ms['fused'][1]:.4f}; means fused "
            f"{statistics.mean(ms['fused']):.4f} layered "
            f"{statistics.mean(ms['layered']):.4f}")
    ops.reset_launches()


def _lags(digest, base) -> collections.Counter:
    """Histogram of each request's larger TTFT or finish lag behind
    ``base`` (the same rids, another run), in ticks."""
    return collections.Counter(max(a[2] - b[2], a[3] - b[3])
                               for a, b in zip(digest, base))


def _differing(digest, base) -> int:
    """Requests whose token contents differ from ``base``'s."""
    return sum(a[1] != b[1] for a, b in zip(digest, base))


def phase_block(torch, ops, cfg, model, params, control, small) -> dict:
    """``--decode-block 4``: a fused dispatch replays one graph of 4
    micro-steps on ticks that admit nothing (the reference's rules).

    1. The control loop at full width, counted: every request finishes,
       the ledger balances, the blocks engaged (more micro-steps than
       dispatches), syncs fall below K = 1's, and the launches are those
       of the micro-steps. Its contents and clocks against K = 1's are
       reported, not gated: the blocks change the schedule and the
       scaling, so a request may be prefilled or decoded beside other rows
       than at K = 1, and cuBLAS's bf16 products are not invariant to the
       batch around a row; the clocks' lag compounds along the queues (the
       reference's schedule, which the CPU tests hold the port to, shows
       it too).
    2. At full width cut to 2 layers, f32: the control loop's token
       contents at K = 4 equal K = 1's.
    3. The reference's bounded case (``tests/test_async_serve.py``), at
       full width, bf16: one replica of 2 slots, 6 requests of 6 new
       tokens, 4 of them queued behind it. Contents equal K = 1's, each
       TTFT and finish lags by 0 to K - 1 ticks, fewer syncs."""
    import numpy as np

    from repro_torch.launch import serve
    from repro_torch.serving.elastic import ElasticClusterFrontend
    from repro_torch.serving.engine import ReplicaEngine, Request

    args = _control_args(serve, "--decode-block", str(BLOCK))
    torch.cuda.synchronize()
    ops.reset_launches()
    out = serve.run_control_loop(args, cfg, model, params,
                                 cache_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    fe, ticks = out["fe"], out["ticks"]
    led, digest = fe.ledger, _digest(fe)
    toks = sum(len(r.output) for r in fe.finished)
    tick_ms = sorted(t["s"] * 1e3 for t in ticks)
    lags = _lags(digest, control["digest"])
    log(f"[block] {cfg.name} --decode-block {BLOCK}: launches {launches}; "
        f"decode dispatches {fe.decode_dispatches()} running "
        f"{fe.decode_steps()} micro-steps, prefill dispatches "
        f"{fe.prefill_dispatches()}; syncs {fe.sync_count()} (K = 1: "
        f"{control['syncs']}); graphs {fe.graph_stats()}; {toks} tokens in "
        f"{out['wall']:.2f}s: {toks / out['wall']:.1f} tok/s (K = 1: "
        f"{control['tok_s']:.1f}); tick wall ms p50 "
        f"{statistics.median(tick_ms):.2f} p95 "
        f"{tick_ms[int(0.95 * (len(tick_ms) - 1))]:.2f} (K = 1: "
        f"{statistics.median(control['tick_ms']):.2f}, "
        f"{control['tick_ms'][int(0.95 * (len(control['tick_ms']) - 1))]:.2f})"
        f"; against K = 1: contents differ in "
        f"{_differing(digest, control['digest'])}/{len(digest)} requests, "
        f"TTFT-or-finish lag histogram {dict(sorted(lags.items()))}")
    if not (led.balanced() and len(fe.finished) == led.submitted
            and all(r.done for r in fe.finished)):
        raise AssertionError(f"ledger {led.balance()}")
    if not (fe.decode_steps() > fe.decode_dispatches()
            and fe.sync_count() < control["syncs"]):
        raise AssertionError("the fused blocks did not engage")
    _check_launches(cfg, launches, fe.prefill_dispatches(),
                    fe.decode_steps(), len(ticks))
    del out, fe
    torch.cuda.empty_cache()

    cfg2, model2, params2 = small
    runs = {}
    for k in (1, BLOCK):
        o = serve.run_control_loop(
            _control_args(serve, "--decode-block", str(k)), cfg2, model2,
            params2, cache_dtype=torch.float32)
        runs[k] = (_digest(o["fe"]), o["fe"].sync_count())
    same = [r[1] for r in runs[BLOCK][0]] == [r[1] for r in runs[1][0]]
    log(f"[block] {cfg.name} f32 full width, 2 layers: contents at K = "
        f"{BLOCK} equal K = 1's: {same}; syncs {runs[BLOCK][1]} against "
        f"{runs[1][1]}; lag histogram "
        f"{dict(sorted(_lags(runs[BLOCK][0], runs[1][0]).items()))}")
    if not same:
        raise AssertionError("f32 contents differ at --decode-block")

    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab_size, rng.integers(3, 9)).tolist()
               for _ in range(6)]
    bounded = {}
    for k in (1, BLOCK):
        fe = ElasticClusterFrontend(
            lambda rid: ReplicaEngine(model, params, max_batch=2,
                                      max_seq=CONTROL_MAX_SEQ, rid=rid,
                                      cache_dtype=torch.bfloat16,
                                      device="cuda"), 1,
            initial_replicas=1, max_replicas_per_node=1, seed=SEED,
            decode_block=k)
        for i, p in enumerate(prompts):
            fe.submit(Request(i, p, max_new_tokens=6))
        fe.run_until_drained()
        bounded[k] = (_digest(fe), fe.sync_count())
    (dk, sk), (d1, s1) = bounded[BLOCK], bounded[1]
    lags = [(a[2] - b[2], a[3] - b[3]) for a, b in zip(dk, d1)]
    ok = (_differing(dk, d1) == 0 and sk < s1
          and all(0 <= x <= BLOCK - 1 for pair in lags for x in pair))
    log(f"[block] {cfg.name} bounded case (1 replica of 2 slots, 6 requests "
        f"of 6 tokens): contents equal {_differing(dk, d1) == 0}; (TTFT, "
        f"finish) lags {lags}; syncs {sk} against {s1}")
    if not ok:
        raise AssertionError("the bounded decode-block case broke its "
                             "contract")
    return {"syncs": runs, "lags": lags}


def phase_federation(torch, ops, cfg, model, params) -> None:
    """The control loop at full width under closed-loop clients
    (``--clients 16``) and as a federation (``--cells 2 --hierarchy`` with
    cell 0 blacked out from tick 15 to 30), counted: the ledger balances
    with nothing served twice and every rid in a terminal state, and the
    launches are those of the runs' dispatches and plane ticks."""
    from repro_torch.launch import serve

    for label, extra in (("clients", ["--clients", "16"]),
                         ("cells", CELL_FLAGS)):
        torch.cuda.synchronize()
        ops.reset_launches()
        out = serve.run_control_loop(_control_args(serve, *extra), cfg,
                                     model, params,
                                     cache_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        fe, led = out["fe"], out["fe"].ledger
        bal = led.balance()
        extra_log = ""
        if out["pool"] is not None:
            extra_log = f"; clients {out['pool'].summary()}"
        if out["sup"] is not None:
            extra_log = (f"; cell downs {fe.cell_downs}, evacuated "
                         f"{fe.evacuated_total}; hierarchy "
                         f"{out['sup'].summary()}")
        log(f"[federation] {cfg.name} {' '.join(extra)}: launches "
            f"{launches}; decode dispatches {fe.decode_dispatches()}, "
            f"prefill dispatches {fe.prefill_dispatches()}, syncs "
            f"{fe.sync_count()}; ledger {bal}{extra_log}; {out['wall']:.2f}s")
        if not (led.balanced() and bal["double_served"] == 0
                and bal["live"] == 0):
            raise AssertionError(f"{label}: ledger {bal}")
        if label == "cells" and fe.cell_downs != 1:
            raise AssertionError("the blackout did not land")
        _check_launches(cfg, launches, fe.prefill_dispatches(),
                        fe.decode_steps(), out["plane"].t)
        del out, fe
        torch.cuda.empty_cache()


def _plan_times(plane) -> None:
    """Host time of one GPSO plan on the card, and of it the key's own
    work: its splits and the seeding of a ``torch.Generator`` for each leaf
    draw. The rest is the plan's launches and its one fetch."""
    import copy

    import numpy as np

    from repro_torch.core.gpso import TorchKey

    spent = {"s": 0.0, "gens": 0}

    class TimedKey(TorchKey):
        def split(self, n=2):
            t0 = time.perf_counter()
            out = [TimedKey(k.seq, k.device) for k in super().split(n)]
            spent["s"] += time.perf_counter() - t0
            return out

        def _gen(self):
            t0 = time.perf_counter()
            g = super()._gen()
            spent["s"] += time.perf_counter() - t0
            spent["gens"] += 1
            return g

    scaler = copy.deepcopy(plane.scaler)
    scaler.key = TimedKey(scaler.key.seq, scaler.key.device)
    n = plane.backend.num_nodes
    demand, current = np.full(n, 4.0, np.float32), np.ones(n, np.int32)
    total, keys = [], []
    for i in range(6):
        spent.update(s=0.0, gens=0)
        t0 = time.perf_counter()
        with plane._on_plane():
            scaler.plan(demand, 1000 + 10 * i, current)
        total.append((time.perf_counter() - t0) * 1e3)
        keys.append(spent["s"] * 1e3)
    cfg = scaler.cluster_cfg
    log(f"[plan] one GPSO plan (population {cfg.ga_pop}, "
        f"{cfg.ga_generations} GA generations, {cfg.pso_iters} PSO "
        f"iterations, {n} nodes): {statistics.median(total[1:]):.2f} ms "
        f"host clock (median of 5), of which key splits and generator "
        f"seeding {statistics.median(keys[1:]):.2f} ms ({spent['gens']} "
        f"generators a plan)")


# ------------------------------------------------------------------ phase 7
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


def _bound(nbytes: float, flops: float, peak: float = BF16_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_decode(torch, F, ops, ref, q, views, pos, label: str) -> dict:
    """flash_decode over ``views`` (one (k, v) per layer, so each launch
    reads another layer, as a decode step does): kernel, plain and sdpa
    times, and the bound from the rows' depths ``pos``."""
    B, G, qpg, hd = q.shape
    S = views[0][0].shape[1]
    L = len(views)
    mask = (torch.arange(S, device="cuda")[None, :]
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
    esz = q.element_size()
    nbytes = (2 * B * G * qpg * hd * esz          # q in, out
              + 2 * filled * G * hd * esz         # K and V rows 0..pos[b]
              + B * 4)                            # pos
    flops = 4 * hd * G * qpg * filled             # q.k and p.v per position
    bound, by = _bound(nbytes, flops)
    log(f"[times] flash_decode {label} B={B} Hq={G * qpg} Hkv={G} hd={hd} "
        f"S={S} pos={pos.tolist()} bf16: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound {bound:.4f} ms ({by}: "
        f"{nbytes} B, {flops} flop)")
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=lib)


def _time_attention(torch, F, ops, ref, gen, kb, sb, G, qpg, hd,
                    label: str, causal: bool = True, sk=None) -> dict:
    """flash_attention at (kb prompts, bucket sb), causal, or full over
    ``sk`` keys (default sb), bf16: kernel, plain and sdpa times, and the
    bound."""
    bf = torch.bfloat16
    sk = sk or sb
    q = torch.randn(kb, sb, G, qpg, hd, generator=gen, device="cuda").to(bf)
    k = torch.randn(kb, sk, G, hd, generator=gen, device="cuda").to(bf)
    v = torch.randn(kb, sk, G, hd, generator=gen, device="cuda").to(bf)
    q4 = q.reshape(kb, sb, G * qpg, hd).transpose(1, 2)
    n = 10
    ms = _graph_ms(torch, lambda: [ops.flash_attention(q, k, v,
                                                       causal=causal)
                                   for _ in range(n)], n)
    plain = _graph_ms(torch, lambda: [ref.flash_attention_ref(
        q, k, v, causal=causal) for _ in range(n)], n)
    lib = _graph_ms(torch, lambda: [F.scaled_dot_product_attention(
        q4, k.transpose(1, 2), v.transpose(1, 2), is_causal=causal,
        enable_gqa=True) for _ in range(n)], n)
    nbytes = 2 * (2 * kb * sb * G * qpg * hd + 2 * kb * sk * G * hd)
    pairs = sb * (sb + 1) // 2 if causal else sb * sk   # scores computed
    flops = 4 * hd * kb * G * qpg * pairs
    bound, by = _bound(nbytes, flops)
    log(f"[times] flash_attention {label} B={kb} S={sb} Sk={sk} "
        f"Hq={G * qpg} Hkv={G} hd={hd} {'causal' if causal else 'full'} "
        f"bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} "
        f"ms, bound {bound:.4f} ms ({by}: {nbytes} B, {flops} flop)")
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=lib)


def phase_times(torch, F, ops, ref, cfg, reps, workload, shapes, control):
    """Kernel, plain and library times at the main paths' shapes. The JSON
    rows are the control loop's shapes (its launches are the rows' counts);
    the drain mode's shapes are timed beside them."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    G, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    qpg = cfg.num_heads // G
    L = cfg.num_layers
    bf = torch.bfloat16
    rows = {}

    # flash_decode, drain mode: one decode step over the served pool's 40
    # layer views at the fill depth of the first 8 requests half-way
    # through their decode
    pool = reps[0].cache
    pos = torch.tensor([min(len(w["prompt"]) + MAX_NEW // 2, MAX_SEQ - 1)
                        for w in workload[:MAX_BATCH]], dtype=torch.int32,
                       device="cuda")
    q = torch.randn(MAX_BATCH, G, qpg, hd, generator=gen,
                    device="cuda").to(bf)
    _time_decode(torch, F, ops, ref, q, [(pool["k"][li], pool["v"][li])
                                         for li in range(L)], pos, "drain")
    # the control loop: one fleet decode dispatch over its largest slab
    # (rows x max_seq 256), every row at a depth its requests reach
    n = control["rows"]
    slab = torch.randn((2, L, n, CONTROL_MAX_SEQ, G, hd), generator=gen,
                       device="cuda").to(bf)
    pos = _ragged_pos(torch, gen, n, *CONTROL_DEPTH)
    q = torch.randn(n, G, qpg, hd, generator=gen, device="cuda").to(bf)
    rows["flash_decode"] = _time_decode(
        torch, F, ops, ref, q, [(slab[0, li], slab[1, li])
                                for li in range(L)], pos, "control slab")
    del slab

    # flash_attention: the largest bucketed prefill of the drain mode, and
    # the control loop's largest fleet prefill (K prompts, bucket sb)
    kb, sb = max((s[1], s[2]) for s in shapes if s[0] == "bucketed")
    _time_attention(torch, F, ops, ref, gen, kb, sb, G, qpg, hd, "drain")
    kb, sb = max(((s[1], s[2]) for s in control["shapes"]
                  if s[0] == "afleet_prefill"), key=lambda s: s[0] * s[1])
    rows["flash_attention"] = _time_attention(
        torch, F, ops, ref, gen, kb, sb, G, qpg, hd, "control fleet prefill")

    # gcn_layer: the balancer's two layers at the serve defaults (the first
    # is the JSON row) and the paper's 16-node cluster
    for (n, f, h), relu in (((2, 12, 64), True), ((2, 64, 64), False),
                            ((16, 36, 64), True)):
        a, x, w, b = _gcn_inputs(torch, gen, (n, f), (f, h))
        act = torch.relu if relu else (lambda t: t)
        n_in = 20
        ms = _graph_ms(torch, lambda: [ops.gcn_layer(a, x, w, b, relu=relu)
                                       for _ in range(n_in)], n_in)
        plain = _graph_ms(torch, lambda: [ref.gcn_layer_ref(a, x, w, b,
                                                            relu=relu)
                                          for _ in range(n_in)], n_in)
        lib = _graph_ms(torch, lambda: [act(torch.addmm(b, a @ x, w))
                                        for _ in range(n_in)], n_in)
        nbytes = 4 * (n * n + n * f + f * h + h + n * h)
        flops = 2 * n * n * f + 2 * n * f * h + n * h
        bound, by = _bound(nbytes, flops, F32_FLOPS_PER_S)
        if "gcn_layer" not in rows:
            rows["gcn_layer"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                     bound_by=by, library_ms=lib)
        log(f"[times] gcn_layer N={n} F={f} H={h} relu={relu} f32: kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, addmm {lib:.4f} ms, bound "
            f"{bound:.6f} ms ({by}: {nbytes} B, {flops} flop)")
    rows["gcn_layer"].update(_time_actor(torch, ops, ref, gen))
    # the main path launches the kernel as the whole action, never as one
    # layer: its launches go with the actor_* times
    rows["gcn_layer"]["launches_of"] = (
        "gcn_actor: one launch a balancer action, timed by actor_ms, "
        "actor_library_ms (the layered chain) and actor_bound_ms; ms, "
        "plain_ms, bound_ms and library_ms time one layer (gcn_layer), "
        "which the main path does not launch at its 2 nodes")
    return rows


def _time_actor(torch, ops, ref, gen) -> dict:
    """The balancer's whole action as the plane calls it (every node up, no
    noise): one gcn_actor launch, the layered chain the port ran before
    (two gcn_layer launches, then the head, mask and softmax as eager ops;
    no single PyTorch call computes the action, so this chain is its
    library yardstick) and the plain version, at the serve defaults (the
    JSON row's actor_* keys) and the paper's 16-node cluster. Bound: A_hat,
    obs, the mask, every weight and bias read once and the fractions
    written once, against the operations of the layers, the head and the
    softmax at 67 TFLOP/s f32; the floor in practice is the launch."""
    from repro_torch.core import ddpg

    out = {}
    for n, f in ((2, 12), (16, 36)):
        a, obs, gcn, head, up, _ = _actor_inputs(torch, gen, n, f)
        actor = {"gcn": gcn, "head": head}
        n_in = 20
        ms = _graph_ms(torch, lambda: [ops.gcn_actor(a, obs, gcn, head,
                                                     up_mask=up)
                                       for _ in range(n_in)], n_in)
        lib = _graph_ms(torch, lambda: [ddpg.actor_action(
            actor, a, obs, up_mask=up, fused=False) for _ in range(n_in)],
            n_in)
        plain = _graph_ms(torch, lambda: [ref.gcn_actor_ref(
            a, obs, gcn, head, up_mask=up) for _ in range(n_in)], n_in)
        dims = [f] + [w.shape[1] for w in gcn["w"]]
        hid = head["w1"].shape[1]
        layers = list(zip(dims[:-1], dims[1:]))
        nbytes = 4 * (n * n + n * f + sum(i * o + o for i, o in layers)
                      + (dims[-1] + f) * hid + 2 * hid + 1 + 2 * n)
        flops = sum(2 * n * n * i + 2 * n * i * o + n * o
                    for i, o in layers) \
            + 2 * n * (dims[-1] + f) * hid + 3 * n * hid + 4 * n
        bound, by = _bound(nbytes, flops, F32_FLOPS_PER_S)
        if not out:
            out = dict(actor_ms=ms, actor_library_ms=lib,
                       actor_bound_ms=bound)
        log(f"[times] gcn_actor N={n} F={f} widths {dims[1:]} head {hid} "
            f"f32: kernel {ms:.4f} ms (one launch), layered {lib:.4f} ms "
            f"({len(layers)} gcn_layer launches + the eager head), plain "
            f"{plain:.4f} ms, bound {bound:.6f} ms ({by}: {nbytes} B, "
            f"{flops} flop)")
    return out


def phase_step_times(torch, cfg, model, params, reps, workload):
    """Host-clock times of one decode step and one prefill of the served
    model, each ending in a synchronise (the engine's own blocking fetch),
    and the decode step's device time alone: the step eager (the model's
    ops launched from Python) and as the drain replica dispatches it (its
    captured graph replayed)."""
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

    # the same decode step and prefill replayed from a CUDA graph: device
    # time alone, without the host's launches
    device_ms = _graph_ms(torch, lambda: model.decode(params, eng.cache, tok,
                                                      pos), 1, reps=5)
    prefill_device_ms = _graph_ms(
        torch, lambda: model.prefill(params, batch,
                                     cache_len=batch["tokens"].shape[1],
                                     cache_dtype=torch.bfloat16), 1, reps=3)
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
    # the engine's own step: its captured graph over its static operands
    eng._step_ops["toks"].copy_(tok)
    eng._step_ops["pos"].copy_(pos)
    eng.graphs.run("decode", eng._decode_next)
    torch.cuda.synchronize()
    host, dev = [], []
    for _ in range(11):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        nxt = eng.graphs.run("decode", eng._decode_next)[0]
        b.record()
        nxt.cpu()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(a.elapsed_time(b))
    graph_ms, graph_dev = statistics.median(host[1:]), statistics.median(
        dev[1:])
    log(f"[steps] {cfg.name} bf16, {MAX_BATCH} slots: decode step eager "
        f"{out['decode step']:.2f} ms (host clock, median of 10), of which "
        f"the device is busy {device_ms:.2f} ms (CUDA-graph replay, median "
        f"of 5): idle share {1 - device_ms / out['decode step']:.2f}; the "
        f"engine's graph-replayed step {graph_ms:.2f} ms host, device "
        f"{graph_dev:.2f} ms (CUDA events, medians of 10): idle share "
        f"{1 - graph_dev / graph_ms:.3f}; prefill "
        f"{tuple(batch['tokens'].shape)} {out['prefill']:.2f} ms (host "
        f"clock, median of 3), device {prefill_device_ms:.2f} ms (CUDA-graph "
        f"replay, median of 3)")


def _fleet_step_times(torch, model, params, rows: int, max_seq: int,
                      cache_dtype=None, layout=None) -> tuple:
    """One fleet decode dispatch at the run's largest slab (``rows`` rows of
    ``max_seq``, every row 24 positions deep, about a prompt and half its
    output) over a ``cache_dtype`` pool (bf16 by default): host clock
    ending in a synchronise, and the device time alone from a CUDA-graph
    replay -- the control loop's idle share. With ``layout`` (a
    ``sharding.HeadLayout``) the slab is split by heads over its devices,
    as a fleet mesh's ``model`` axis splits it. Returns (host ms, device
    ms)."""
    cache_dtype = cache_dtype or torch.bfloat16
    slab = model.init_serve_state(rows, max_seq, cache_dtype,
                                  device="cuda" if layout is None else "meta")
    if layout is not None:
        slab = layout(slab, "serve_state")
    tok = torch.ones((rows, 1), dtype=torch.int32, device="cuda")
    pos = torch.full((rows,), 24, dtype=torch.int32, device="cuda")

    def step():
        logits, _ = model.decode(params, slab, tok, pos)
        return torch.argmax(logits, dim=-1)

    device_ms = _graph_ms(torch, step, 1, reps=5)
    times = []
    for _ in range(6):
        t0 = time.perf_counter()
        step().cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    host_ms = statistics.median(times[1:])
    split = "" if layout is None else \
        f", heads over {len(layout.devices)} model devices"
    log(f"[control] fleet decode dispatch eager, {rows} slab rows x "
        f"{max_seq}, {cache_dtype} cache{split}: {host_ms:.2f} ms host clock "
        f"(median of 5), device busy {device_ms:.2f} ms (CUDA-graph replay, "
        f"median of 5): idle share {1 - device_ms / host_ms:.2f}")
    return host_ms, device_ms


# ------------------------------------------------------------------ phase 8
def phase_oracles(torch, cfg, model, params, control, small) -> list:
    """Async against eager in bf16; at full width cut to 2 layers in f32,
    the fleet path against per-replica decode and the kernel path against
    the einsum path. Returns the f32 fleet kernel run's digest."""
    from repro_torch.launch import serve

    out = serve.run_control_loop(_control_args(serve, "--no-async"), cfg,
                                 model, params, cache_dtype=torch.bfloat16)
    same = _digest(out["fe"]) == control["digest"]
    log(f"[oracle] bf16 full width: async (graph replays) vs --no-async "
        f"(eager) digests identical: {same} ({len(control['digest'])} "
        f"requests; eager syncs {out['fe'].sync_count()})")
    if not same:
        raise AssertionError("async and eager control loops differ")
    del out
    torch.cuda.empty_cache()

    cfg2, model2, params2 = small
    runs = {}
    for name, extra in (("fleet", ()), ("no-fleet", ("--no-fleet",)),
                        ("einsum", ("--attn-backend", "einsum"))):
        out = serve.run_control_loop(_control_args(serve, *extra), cfg2,
                                     model2, params2,
                                     cache_dtype=torch.float32)
        runs[name] = (_digest(out["fe"]), sum(t["decode_dispatches"]
                                              for t in out["ticks"]))
        del out
    n_tok = sum(len(r[1]) for r in runs["fleet"][0])
    log(f"[oracle] f32 full width, 2 layers: {len(runs['fleet'][0])} "
        f"requests, {n_tok} tokens; digests identical to the fleet kernel "
        f"run: --no-fleet {runs['no-fleet'][0] == runs['fleet'][0]}, "
        f"--attn-backend einsum {runs['einsum'][0] == runs['fleet'][0]}; "
        f"decode dispatches in the ticks: fleet {runs['fleet'][1]}, "
        f"no-fleet {runs['no-fleet'][1]}")
    for name in ("no-fleet", "einsum"):
        if runs[name][0] != runs["fleet"][0]:
            raise AssertionError(f"the {name} control loop differs from the "
                                 "fleet kernel run")
    torch.cuda.empty_cache()
    return runs["fleet"][0]


def phase_fleet_write(torch, small):
    """One fleet decode dispatch of a sub-step round (only some fleet rows
    step) at the control loop's largest slab, f32, 2 layers: the rows that
    do not step keep their cache bit for bit, the stepping rows change only
    at their write index, and the kernel path's logits match the einsum
    path's."""
    cfg2, model2, params2 = small
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    n, S = 32, CONTROL_MAX_SEQ
    slab = model2.init_serve_state(n, S, torch.float32, device="cuda")
    for c in slab.values():
        c.normal_(generator=gen)
    pos = _ragged_pos(torch, gen, n, *CONTROL_DEPTH)
    tok = torch.randint(1, cfg2.vocab_size, (n, 1), generator=gen,
                        device="cuda", dtype=torch.int32)
    # fleet rows 0 and 2 of four (max_batch 8) step; 1 and 3 do not
    write = torch.cat([torch.arange(0, 8), torch.arange(16, 24)]).to(
        device="cuda", dtype=torch.int32)
    keep = torch.ones(n, dtype=torch.bool, device="cuda")
    keep[write.long()] = False
    wl, at = write.long(), pos[write.long()].long()
    logits = {}
    for backend in ("pallas", "einsum"):
        cache = {k: c.clone() for k, c in slab.items()}
        logits[backend], _ = model2.decode(params2, cache, tok, pos,
                                           attn_backend=backend,
                                           write_rows=write)
        for k, c in cache.items():
            want = slab[k].clone()
            want[:, wl, at] = c[:, wl, at]
            if not (torch.equal(c[:, keep], slab[k][:, keep])
                    and torch.equal(c, want)
                    and not torch.equal(c[:, wl, at], slab[k][:, wl, at])):
                raise AssertionError(f"{backend}: the fleet write of {k} "
                                     "touched rows or positions it must not")
    k, e = logits["pallas"], logits["einsum"]
    rel = ((k - e).abs().max() / e.abs().max()).item()
    log(f"[fleet] f32 full width, 2 layers, {n} slab rows x {S}, rows "
        f"{write.tolist()} stepping at pos {pos.tolist()}: non-stepping rows "
        f"unchanged, stepping rows written only at pos; logits "
        f"max|kernel-einsum| / max|einsum| = {rel:.3e} (tolerance "
        f"{F32_PATH_TOL})")
    if not rel <= F32_PATH_TOL:
        raise AssertionError(f"fleet decode logits differ by {rel:.3e}")


# ------------------------------------------------------------------ phase 9
# chunked prefill and the int8 KV cache, at full width: the archs whose
# chunk path runs (dense, ssm, hybrid), with an f32 cache (the only cache a
# replica chunks with) under the bf16 weights
CHUNK_ARCHS = SERVED[:3]
DRAIN_CHUNK, CONTROL_CHUNK = 128, 4


class _ChunkCounter:
    """Counts the engine's chunk dispatches and checks each one's launches:
    ``serving.engine._chunk_dispatch`` wrapped for one run (a dispatch's
    launch counts are host-side, so the difference across the call is that
    dispatch's own)."""

    def __init__(self, engine_mod, ops, per: dict):
        self.mod, self.ops, self.per = engine_mod, ops, per
        self.orig = engine_mod._chunk_dispatch
        self.calls, self.rows, self.bad = 0, 0, []

    def __enter__(self):
        def counted(*args, **kw):
            before = dict(self.ops.LAUNCHES)
            out = self.orig(*args, **kw)
            got = {k: self.ops.LAUNCHES[k] - before[k] for k in before}
            if {k: got[k] for k in self.per} != self.per:
                self.bad.append(got)
            self.calls += 1
            self.rows += len(args[5])
            return out
        self.mod._chunk_dispatch = counted
        return self

    def __exit__(self, *exc):
        self.mod._chunk_dispatch = self.orig


def _chunk_launches(cfg) -> dict:
    """Launches of one chunk dispatch: flash_attention once per attention
    layer (the hybrid's shared block once per invocation), ssd_scan once
    per mamba layer, no decode."""
    return {k: p for k, (p, d) in _per_dispatch(cfg).items()}


def _ttft_report(finished, chunk: int, max_seq: int) -> str:
    """Chunked prompts' TTFT in ticks (first token - arrival) against
    ceil(len / chunk): the first chunk runs in the admission tick, so a
    prompt of n chunks has its first token n - 1 ticks after admission,
    and TTFT >= n - 1."""
    import math
    reqs = [r for r in finished if r.first_token_time is not None
            and min(len(r.prompt), max_seq - 1) > chunk]
    if not reqs:
        return "no chunked prompts"
    ttft = [r.first_token_time - r.arrival for r in reqs]
    need = [math.ceil(min(len(r.prompt), max_seq - 1) / chunk) for r in reqs]
    return (f"{len(reqs)} chunked prompts: TTFT mean {statistics.mean(ttft):.2f} "
            f"ticks (min {min(ttft):.0f}, max {max(ttft):.0f}) against "
            f"ceil(len / {chunk}) mean {statistics.mean(need):.2f} (min "
            f"{min(need)}, max {max(need)}); TTFT >= ceil - 1 for "
            f"{sum(t >= n - 1 for t, n in zip(ttft, need))}/{len(reqs)}")


def _outputs(finished) -> dict:
    return {r.rid: tuple(r.output) for r in finished}


def _differ(a: dict, b: dict) -> int:
    return sum(a[k] != b.get(k) for k in a)


def _chunk_dispatch_ms(torch, model, params, cache, chunk: int, rows: int,
                       offset: int, backend: str = "pallas") -> tuple:
    """One chunk dispatch (``rows`` rows of ``chunk`` tokens at cache
    offset ``offset``) on ``cache``: host ms to the results through the
    engine's own path (staging, the eager model, the engine's fetch;
    median of 5 after a warm-up), and the device ms of the same chunk step
    replayed from a CUDA graph (the device's busy time alone; CUDA events
    around an eager dispatch would span the host's launch gaps too). It
    writes the rows' cache at [offset, offset + chunk): the cache is
    scratch here."""
    import numpy as np

    from repro_torch.serving.engine import _chunk_dispatch, _stage

    items = [(r, np.arange(1, chunk + 1, dtype=np.int32), offset, chunk,
              False) for r in range(rows)]
    dev = torch.device("cuda")
    host = []
    for _ in range(6):
        t0 = time.perf_counter()
        first, _ = _chunk_dispatch(model, params, cache, dev, backend,
                                   items, chunk)
        first.cpu()
        host.append((time.perf_counter() - t0) * 1e3)
    toks, offs, lens, idx = _stage(
        dev, np.tile(np.arange(1, chunk + 1, dtype=np.int32), (rows, 1)),
        np.full(rows, offset), np.full(rows, chunk), np.arange(rows))
    device = _graph_ms(torch, lambda: model.prefill_chunk(
        params, cache, toks, offs, lens, rows=idx, attn_backend=backend), 1,
        reps=5)
    return statistics.median(host[1:]), device


def phase_chunk(torch, ops, cfg, model, params, workload, small) -> dict:
    """``--chunk-len`` at full width with an f32 cache (bf16 weights):

    1. drain mode over the 16-request workload with ``--chunk-len 128``
       (prompts up to 512 tokens: up to 4 chunks), counted: every request
       finishes, every chunk dispatch launches flash_attention once per
       attention layer and ssd_scan once per mamba layer (and nothing of
       decode), the run's launches are those of its prefill, chunk and
       decode dispatches; its streams against the single-shot run's with
       the same f32 cache are reported, as are one chunk dispatch's host
       and device ms;
    2. the control loop of phase 6 with ``--chunk-len 4`` (its prompts are
       2-11 tokens), counted the same way, ledger balanced, the chunked
       prompts' TTFT against ceil(len / 4), streams against single-shot
       reported;
    3. at full width cut to 2 layers, f32 weights: drain mode chunked
       equals single-shot, token for token, on both backends."""
    from repro_torch.launch import serve
    from repro_torch.serving import engine as engine_mod

    per = _chunk_launches(cfg)
    f32 = torch.float32
    out = {}
    # 1. drain mode
    args = _serve_args(serve)
    args.chunk_len = DRAIN_CHUNK
    runs = {}
    for label, chunk in (("chunked", DRAIN_CHUNK), ("single-shot", 0)):
        args.chunk_len = chunk
        torch.cuda.synchronize()
        ops.reset_launches()
        with _ChunkCounter(engine_mod, ops, per) as cc:
            fe, reps, wall = serve.run_drain_mode(args, cfg, model, params,
                                                  cache_dtype=f32,
                                                  workload=workload)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        steps = sum(r.steps for r in reps)
        dispatches = sum(r.prefill_dispatches for r in reps)
        if len(fe.finished) != N_REQUESTS or not all(r.done
                                                     for r in fe.finished):
            raise AssertionError(f"{label}: {len(fe.finished)}/{N_REQUESTS} "
                                 "finished")
        _check_launches(cfg, launches, dispatches, steps)
        if cc.bad or (chunk and not cc.calls):
            raise AssertionError(f"chunk dispatches {cc.calls}, with launches "
                                 f"other than {per}: {cc.bad[:3]}")
        toks = sum(len(r.output) for r in fe.finished)
        runs[label] = _outputs(fe.finished)
        log(f"[chunk] {cfg.name} drain mode, f32 cache, --chunk-len {chunk}: "
            f"launches {launches}; decode steps {steps}, prefill dispatches "
            f"{dispatches} of which chunk dispatches {cc.calls} ({cc.rows} "
            f"chunk rows, each dispatch {per}); {toks} tokens in "
            f"{wall:.2f}s: {toks / wall:.1f} tok/s")
        if chunk:
            out["drain_launches"] = launches
            out["chunk_calls"] = cc.calls
            cache = reps[0].cache
            host, dev = _chunk_dispatch_ms(torch, model, params, cache,
                                           DRAIN_CHUNK, MAX_BATCH,
                                           DRAIN_CHUNK)
            out["chunk_ms"] = (host, dev)
            log(f"[chunk] {cfg.name} one chunk dispatch, {MAX_BATCH} rows x "
                f"{DRAIN_CHUNK} tokens at offset {DRAIN_CHUNK}: host "
                f"{host:.2f} ms to the results (median of 5), device busy "
                f"{dev:.2f} ms (CUDA-graph replay, median of 5): idle share "
                f"{1 - dev / host:.3f}")
        del fe, reps
    log(f"[chunk] {cfg.name} full width bf16 weights, f32 cache: streams "
        f"differing between chunked and single-shot drain runs "
        f"{_differ(runs['chunked'], runs['single-shot'])}/{N_REQUESTS} "
        "(reported: the chunk's attention reads the f32 pool, single-shot "
        "attends its bf16 projections)")
    _free(torch)

    # 2. the control loop
    digests = {}
    for chunk in (CONTROL_CHUNK, 0):
        torch.cuda.synchronize()
        ops.reset_launches()
        with _ChunkCounter(engine_mod, ops, per) as cc:
            res = serve.run_control_loop(
                _control_args(serve, "--chunk-len", str(chunk)), cfg, model,
                params, cache_dtype=f32)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        fe = res["fe"]
        led = fe.ledger
        if not (led.balanced() and len(fe.finished) == led.submitted
                and all(r.done for r in fe.finished)):
            raise AssertionError(f"ledger {led.balance()}")
        _check_launches(cfg, launches, fe.prefill_dispatches(),
                        fe.decode_steps(), len(res["ticks"]))
        if cc.bad or (chunk and not cc.calls):
            raise AssertionError(f"chunk dispatches {cc.calls}, with launches "
                                 f"other than {per}: {cc.bad[:3]}")
        digests[chunk] = _outputs(fe.finished)
        toks = sum(len(r.output) for r in fe.finished)
        tick_ms = statistics.median(t["s"] * 1e3 for t in res["ticks"])
        log(f"[chunk] {cfg.name} control loop, f32 cache, --chunk-len "
            f"{chunk}: {toks / res['wall']:.1f} tok/s, tick wall p50 "
            f"{tick_ms:.2f} ms")
        if chunk:
            out["control_launches"] = launches
            out["control_chunk_calls"] = cc.calls
            log(f"[chunk] {cfg.name} control loop, f32 cache, --chunk-len "
                f"{chunk}: launches {launches}; decode dispatches "
                f"{fe.decode_dispatches()}, prefill dispatches "
                f"{fe.prefill_dispatches()} of which chunk dispatches "
                f"{cc.calls} ({cc.rows} chunk rows); syncs "
                f"{fe.sync_count()}; {len(fe.finished)} requests, ledger "
                f"balanced; {_ttft_report(fe.finished, chunk, CONTROL_MAX_SEQ)}")
        del res, fe
    log(f"[chunk] {cfg.name} control loop streams differing between "
        f"--chunk-len {CONTROL_CHUNK} and single-shot (f32 cache): "
        f"{_differ(digests[CONTROL_CHUNK], digests[0])}/"
        f"{len(digests[0])} (reported: chunking changes the schedule, so "
        "rows decode beside other rows)")
    _free(torch)

    # 3. exactness at 2 layers, f32
    cfg2, model2, params2 = small
    same = {}
    for backend in ("pallas", "einsum"):
        streams = {}
        for chunk in (DRAIN_CHUNK, 0):
            a = _serve_args(serve, backend)
            a.chunk_len = chunk
            fe, _, _ = serve.run_drain_mode(a, cfg2, model2, params2,
                                            cache_dtype=f32,
                                            workload=workload)
            streams[chunk] = _outputs(fe.finished)
        same[backend] = streams[DRAIN_CHUNK] == streams[0]
    log(f"[chunk] {cfg.name} f32 full width, 2 layers, drain mode: chunked "
        f"streams equal single-shot: {same}")
    if not all(same.values()):
        raise AssertionError(f"chunked streams differ from single-shot: "
                             f"{same}")
    _free(torch)
    return out


def _pool_bytes(model, dtype) -> int:
    """Device bytes of one slot's KV pool at the drain mode's max_seq."""
    st = model.init_serve_state(1, MAX_SEQ, dtype, device="cuda")
    n = sum(t.numel() * t.element_size() for t in st.values())
    del st
    return n


def phase_int8(torch, ops, cfg, model, params, workload, small,
               control) -> dict:
    """The int8 KV cache at full width (``cache_dtype="int8"``, the engine
    API: the reference's serve has no flag for it), bf16 weights:

    1. drain mode, counted: every request finishes, every decode step reads
       the int8 pool through flash_decode once per layer;
    2. the control loop with int8 replicas (async, decode graphs),
       counted, ledger balanced, its digest equal to the int8 ``--no-async``
       oracle's; its streams against phase 6's bf16 cache reported
       (quantization may change tokens);
    3. at full width cut to 2 layers, f32 weights: the int8 control loop on
       the kernel path equals ``--attn-backend einsum``'s;
    4. pool bytes a slot and the fleet decode dispatch's host / device ms
       against the bf16 cache's."""
    from repro_torch.launch import serve

    out = {}
    torch.cuda.synchronize()
    ops.reset_launches()
    fe, reps, wall = serve.run_drain_mode(_serve_args(serve), cfg, model,
                                          params, cache_dtype="int8",
                                          workload=workload)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    steps = sum(r.steps for r in reps)
    dispatches = sum(r.prefill_dispatches for r in reps)
    if len(fe.finished) != N_REQUESTS:
        raise AssertionError(f"int8: {len(fe.finished)}/{N_REQUESTS} "
                             "finished")
    if set(reps[0].cache) != {"k_q", "v_q", "k_s", "v_s"}:
        raise AssertionError(f"int8 pool leaves {set(reps[0].cache)}")
    _check_launches(cfg, launches, dispatches, steps)
    toks = sum(len(r.output) for r in fe.finished)
    log(f"[int8] {cfg.name} drain mode, int8 cache: launches {launches}; "
        f"decode steps {steps} (flash_decode over int8 once a layer a "
        f"step), prefill dispatches {dispatches}; {toks} tokens in "
        f"{wall:.2f}s: {toks / wall:.1f} tok/s")
    out["drain_launches"] = launches
    del fe, reps
    _free(torch)

    digests = {}
    for name, extra in (("async", ()), ("eager", ("--no-async",))):
        torch.cuda.synchronize()
        ops.reset_launches()
        res = serve.run_control_loop(_control_args(serve, *extra), cfg, model,
                                     params, cache_dtype="int8")
        torch.cuda.synchronize()
        fe = res["fe"]
        led = fe.ledger
        if not (led.balanced() and len(fe.finished) == led.submitted):
            raise AssertionError(f"int8 ledger {led.balance()}")
        _check_launches(cfg, dict(ops.LAUNCHES), fe.prefill_dispatches(),
                        fe.decode_steps(), len(res["ticks"]))
        digests[name] = _digest(fe)
        if name == "async":
            out["control_launches"] = dict(ops.LAUNCHES)
            rows = fe.peak_slab_rows()
            toks = sum(len(r.output) for r in fe.finished)
            tick_ms = statistics.median(t["s"] * 1e3 for t in res["ticks"])
            log(f"[int8] {cfg.name} control loop, int8 replicas: "
                f"{toks / res['wall']:.1f} tok/s, tick wall p50 "
                f"{tick_ms:.2f} ms; launches "
                f"{dict(ops.LAUNCHES)}; decode dispatches "
                f"{fe.decode_dispatches()}, prefill dispatches "
                f"{fe.prefill_dispatches()}, syncs {fe.sync_count()}; graphs "
                f"{fe.graph_stats()}; peak slab rows {rows}")
        del res, fe
    same = digests["async"] == digests["eager"]
    bf16 = {d[0]: d[1] for d in control["digest"]}
    differ = sum(bf16.get(d[0]) != d[1] for d in digests["async"])
    log(f"[int8] {cfg.name} int8 async (graph replays) vs --no-async digests "
        f"identical: {same}; streams differing from the bf16 cache's "
        f"control loop (phase 6): {differ}/{len(digests['async'])} "
        "(reported: quantization may change tokens)")
    if not same:
        raise AssertionError("int8 async and eager control loops differ")
    _free(torch)

    cfg2, model2, params2 = small
    runs = {}
    for backend in ("pallas", "einsum"):
        res = serve.run_control_loop(
            _control_args(serve, "--attn-backend", backend), cfg2, model2,
            params2, cache_dtype="int8")
        runs[backend] = _digest(res["fe"])
        del res
    log(f"[int8] f32 full width, 2 layers, int8 cache: control-loop digest "
        f"kernel path == --attn-backend einsum: "
        f"{runs['pallas'] == runs['einsum']}")
    if runs["pallas"] != runs["einsum"]:
        raise AssertionError("int8 kernel and einsum control loops differ")

    b8, b16 = _pool_bytes(model, "int8"), _pool_bytes(model, torch.bfloat16)
    log(f"[int8] {cfg.name} KV pool a slot at max_seq {MAX_SEQ}: int8 "
        f"{b8 / 2**20:.1f} MiB against bf16 {b16 / 2**20:.1f} MiB "
        f"({b8 / b16:.3f} of it)")
    rows = control["rows"]
    for dt in ("int8", torch.bfloat16):
        host, dev = _fleet_step_times(torch, model, params, rows,
                                      CONTROL_MAX_SEQ, cache_dtype=dt)
        out[f"step_{dt}"] = (host, dev)
    _free(torch)
    return out


def _variant_inputs_offset(torch, gen, R, B, C, Sk, G, qpg, hd, dt):
    q = torch.randn(B, C, G, qpg, hd, generator=gen, device="cuda").to(dt)
    k = torch.randn(R, Sk, G, hd, generator=gen, device="cuda").to(dt)
    v = torch.randn(R, Sk, G, hd, generator=gen, device="cuda").to(dt)
    off = torch.randint(0, Sk - C + 1, (B,), generator=gen, device="cuda",
                        dtype=torch.int32)
    off[0] = 0
    off[-1] = Sk - C
    rows = torch.randperm(R, generator=gen, device="cuda")[:B].to(torch.int32)
    return q, k, v, off, rows


def _int8_cache(torch, gen, B, S, G, hd):
    from repro_torch.serving import kv_quant
    kq, ks = kv_quant.quantize(torch.randn(B, S, G, hd, generator=gen,
                                           device="cuda"))
    vq, vs = kv_quant.quantize(torch.randn(B, S, G, hd, generator=gen,
                                           device="cuda"))
    return kq, vq, ks, vs


def phase_parity_variants(torch, ops, ref, gen) -> dict:
    """This round's three kernel variants against their plain versions on
    the card: ssd_scan from a random non-zero ``init_state`` at both ssm
    archs' chunk shapes (the drain mode's 8 x 128, the control loop's K x
    4, a chunk of 8, and 384 steps padded to 512 against ssm_chunk 256),
    every (tile, hpb) instantiation; flash_attention with ragged
    ``q_offset`` (0 and S - C among them) and ``kv_rows`` over a larger
    pool at every head layout, f32 and bf16 (the drain chunk, 8 x 128 over
    8 x 1024; the control loop's, up to 8 x 4 over 32 x 256); flash_decode
    over an int8 pool (the drain pool, 8 x 1024, and the 32-row slab x
    256) at every head layout, q in f32 and bf16."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as ssd

    errs = {"ssd_scan": 0.0, "flash_attention": 0.0, "flash_decode": 0.0}
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for name in SSM_ARCHS:
        cfg = get_config(name)
        H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        for B, T in ((8, 128), (16, 4), (8, 8), (1, 512)):
            x, a, bm, cm = _ssd_inputs(torch, gen, B, T, H, P, N)
            s0 = torch.randn(B, H, P, N, generator=gen, device="cuda") * 0.3
            chunk = min(cfg.ssm_chunk, T)
            y_ref, st_ref = ref.ssd_scan_ref(x, a, bm, cm, chunk,
                                             init_state=s0)
            worst = 0.0
            for tile in ssd.TILES:
                for h in range(1, ssd.MAX_HPB + 1):
                    y, st = torch.empty_like(x), torch.empty_like(s0)
                    ssd.launch(x, a, bm, cm, y, st, instantiation=(tile, h),
                               init_state=s0)
                    torch.cuda.synchronize()
                    for got, want in ((y, y_ref), (st, st_ref)):
                        torch.testing.assert_close(
                            got, want, **SSD_TOL,
                            msg=lambda m: f"ssd_scan init_state {name} "
                            f"({B}, {T}) tile {tile} hpb {h}: {m}")
                    worst = max(worst, (y - y_ref).abs().max().item(),
                                (st - st_ref).abs().max().item())
            y, st = ops.ssd_scan(x, a, bm, cm, chunk=chunk, init_state=s0)
            torch.testing.assert_close(y, y_ref, **SSD_TOL)
            errs["ssd_scan"] = max(errs["ssd_scan"], worst)
            log(f"[parity] ssd_scan init_state {name} B={B} T={T} H={H} "
                f"P={P} N={N} chunk={chunk} f32, every (tile, hpb): max|err| "
                f"{worst:.3e} (atol/rtol {SSD_TOL['atol']})")
    for G, qpg, hd in HEAD_LAYOUTS:
        for R, B, C, Sk in ((MAX_BATCH, MAX_BATCH, DRAIN_CHUNK, MAX_SEQ),
                            (32, 8, CONTROL_CHUNK, CONTROL_MAX_SEQ),
                            (32, 3, CONTROL_CHUNK, CONTROL_MAX_SEQ)):
            for dname, dt in dtypes.items():
                q, k, v, off, rows = _variant_inputs_offset(
                    torch, gen, R, B, C, Sk, G, qpg, hd, dt)
                got = ops.flash_attention(q, k, v, q_offset=off,
                                          kv_rows=rows)
                torch.cuda.synchronize()
                err = _close("flash_attention q_offset", got,
                             ref.flash_attention_ref(q, k, v, q_offset=off,
                                                     kv_rows=rows),
                             dname, torch)
                if not torch.isfinite(got.float()).all():
                    raise AssertionError("flash_attention q_offset: "
                                         "non-finite rows")
                errs["flash_attention"] = max(errs["flash_attention"], err)
                log(f"[parity] flash_attention q_offset Hq={G * qpg} "
                    f"Hkv={G} hd={hd} pool {R} x {Sk}, {B} rows x {C} at "
                    f"offsets {off.tolist()} rows {rows.tolist()} {dname}: "
                    f"max|err|={err:.3e} (atol/rtol {TOLS[dname]['atol']})")
        for B, S in ((MAX_BATCH, MAX_SEQ), (32, CONTROL_MAX_SEQ)):
            kq, vq, ks, vs = _int8_cache(torch, gen, B, S, G, hd)
            pos = _ragged_pos(torch, gen, B, 0, S - 1)
            for dname, dt in dtypes.items():
                q = torch.randn(B, G, qpg, hd, generator=gen,
                                device="cuda").to(dt)
                got = ops.flash_decode(q, kq, vq, pos, ks, vs)
                torch.cuda.synchronize()
                err = _close("flash_decode int8", got,
                             ref.flash_decode_ref(q, kq, vq, pos, k_scale=ks,
                                                  v_scale=vs), dname, torch)
                errs["flash_decode"] = max(errs["flash_decode"], err)
                log(f"[parity] flash_decode int8 B={B} Hq={G * qpg} Hkv={G} "
                    f"hd={hd} S={S} q {dname}: max|err|={err:.3e} (atol/rtol "
                    f"{TOLS[dname]['atol']})")
    return errs


def phase_times_variants(torch, F, ops, ref, served) -> dict:
    """Times of the three variants at the main paths' shapes: kernel,
    plain version, the library call on the same inputs and the bound.
    flash_attention with q_offset: granite's drain chunk (8 rows x 128
    tokens at ragged offsets over its 8 x 1024 f32 pool; the chunk path
    attends in the cache's f32, so the f32 peak bounds it); the library
    call is SDPA over the rows' pool slices with the offset mask. ssd_scan
    from init_state: mamba2's drain chunk (8 x 128) and control-loop chunk
    (8 x 4); no library call. flash_decode over int8: granite's control
    slab (32 x 256) and drain pool (8 x 1024); the library call is SDPA on
    the dequantized cache (the dequant not timed). Bytes count each input
    once (the int8 pool's live rows and scales), operations what these
    inputs need."""
    from repro_torch.configs import get_config

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    out = {}
    cfg = get_config("granite-3-8b")
    G, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    qpg = cfg.num_heads // G
    L = 10            # layer views timed in one graph
    # flash_attention, q_offset
    f32 = torch.float32
    R, B, C, Sk = MAX_BATCH, MAX_BATCH, DRAIN_CHUNK, MAX_SEQ
    q, k, v, off, rows = _variant_inputs_offset(torch, gen, R, B, C, Sk, G,
                                                qpg, hd, f32)
    off = torch.arange(B, dtype=torch.int32, device="cuda") % 4 * C
    kr, vr = k[rows.long()], v[rows.long()]
    qpos = off.long()[:, None] + torch.arange(C, device="cuda")
    mask = (torch.arange(Sk, device="cuda")[None, None, :]
            <= qpos[:, :, None])[:, None]                # (B, 1, C, Sk)
    q4 = q.reshape(B, C, G * qpg, hd).transpose(1, 2)
    ms = _graph_ms(torch, lambda: [ops.flash_attention(
        q, k, v, q_offset=off, kv_rows=rows) for _ in range(L)], L)
    plain = _graph_ms(torch, lambda: [ref.flash_attention_ref(
        q, k, v, q_offset=off, kv_rows=rows) for _ in range(L)], L)
    lib = _graph_ms(torch, lambda: [F.scaled_dot_product_attention(
        q4, kr.transpose(1, 2), vr.transpose(1, 2), attn_mask=mask,
        enable_gqa=True) for _ in range(L)], L)
    keys = int((qpos + 1).sum())                 # (query, key) pairs a head
    frontier = int((off.long() + C).sum())       # K/V rows read, per group
    nbytes = 4 * (2 * B * C * G * qpg * hd + 2 * frontier * G * hd + 2 * B)
    flops = 4 * hd * G * qpg * keys
    bound, by = _bound(nbytes, flops, F32_FLOPS_PER_S)
    log(f"[times] flash_attention q_offset granite drain chunk {B} rows x "
        f"{C} at offsets {off.tolist()} over {R} x {Sk} f32: kernel "
        f"{ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound "
        f"{bound:.4f} ms ({by}: {nbytes} B, {flops} flop at f32)")
    out["flash_attention"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                  bound_by=by, library_ms=lib,
                                  shape=f"{B}x{C} at offsets over {R}x{Sk}, "
                                  "f32")
    # ssd_scan, init_state
    m2 = get_config(SSM_ARCHS[0])
    H, P, N = m2.ssm_heads, m2.ssm_head_dim, m2.ssm_state
    for label, (Bs, T) in (("drain chunk", (MAX_BATCH, DRAIN_CHUNK)),
                           ("control chunk", (MAX_BATCH, CONTROL_CHUNK))):
        x, a, bm, cm = _ssd_inputs(torch, gen, Bs, T, H, P, N)
        s0 = torch.randn(Bs, H, P, N, generator=gen, device="cuda") * 0.3
        n = 10
        ms = _graph_ms(torch, lambda: [ops.ssd_scan(
            x, a, bm, cm, chunk=T, init_state=s0) for _ in range(n)], n)
        plain = _graph_ms(torch, lambda: [ref.ssd_scan_ref(
            x, a, bm, cm, T, init_state=s0) for _ in range(n)], n)
        fma = 0
        for t0 in range(0, T, SSD_OPS_BLOCK):
            qq = min(SSD_OPS_BLOCK, T - t0)
            tri = qq * (qq + 1) // 2
            fma += tri * N + H * (tri * P + 2 * qq * P * N)
        flops = 2 * Bs * fma
        nbytes = 4 * (2 * Bs * T * H * P + Bs * T * H + 2 * Bs * T * N
                      + 2 * Bs * H * P * N)     # init state in, state out
        bound, by = _bound(nbytes, SSD_PASSES * flops, TF32_FLOPS_PER_S)
        log(f"[times] ssd_scan init_state {m2.name} {label} B={Bs} T={T} "
            f"f32: kernel {ms:.4f} ms, plain {plain:.4f} ms, library none, "
            f"bound {bound:.4f} ms ({by}: {nbytes} B, {SSD_PASSES} x {flops} "
            "flop at TF32)")
        if label.startswith("drain"):
            out["ssd_scan"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                   bound_by=by, library_ms=None,
                                   shape=f"{Bs}x{T}, H {H} P {P} N {N}")
    # flash_decode, int8
    bf = torch.bfloat16
    n_rows = served["granite-3-8b"]["slab_rows"]
    for label, (Bd, S, pos) in (
            ("control slab", (n_rows, CONTROL_MAX_SEQ,
                              _ragged_pos(torch, gen, n_rows,
                                          *CONTROL_DEPTH))),
            ("drain pool", (MAX_BATCH, MAX_SEQ,
                            _ragged_pos(torch, gen, MAX_BATCH, 300, 700)))):
        views = [_int8_cache(torch, gen, Bd, S, G, hd) for _ in range(L)]
        q = torch.randn(Bd, G, qpg, hd, generator=gen, device="cuda").to(bf)
        deq = [(ref.dequantize_kv(kq, ks, bf), ref.dequantize_kv(vq, vs, bf))
               for kq, vq, ks, vs in views]
        dmask = (torch.arange(S, device="cuda")[None, :]
                 <= pos[:, None])[:, None, None, :]
        qs = q.reshape(Bd, G * qpg, 1, hd)
        ms = _graph_ms(torch, lambda: [ops.flash_decode(q, kq, vq, pos, ks, vs)
                                       for kq, vq, ks, vs in views], L)
        plain = _graph_ms(torch, lambda: [ref.flash_decode_ref(
            q, kq, vq, pos, k_scale=ks, v_scale=vs)
            for kq, vq, ks, vs in views], L)
        lib = _graph_ms(torch, lambda: [F.scaled_dot_product_attention(
            qs, kd.transpose(1, 2), vd.transpose(1, 2), attn_mask=dmask,
            enable_gqa=True) for kd, vd in deq], L)
        filled = int((pos.long() + 1).sum())
        nbytes = (2 * Bd * G * qpg * hd * 2          # q in, out (bf16)
                  + 2 * filled * G * hd              # int8 K and V rows
                  + 2 * filled * G * 4 + Bd * 4)     # their scales, pos
        flops = 4 * hd * G * qpg * filled
        bound, by = _bound(nbytes, flops)
        log(f"[times] flash_decode int8 granite {label} B={Bd} S={S} "
            f"pos={pos.tolist()} q bf16: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, sdpa (dequantized) {lib:.4f} ms, bound "
            f"{bound:.4f} ms ({by}: {nbytes} B, {flops} flop)")
        if label.startswith("control"):
            out["flash_decode"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                       bound_by=by, library_ms=lib,
                                       shape=f"{Bd}x{S} int8, q bf16")
        del views, deq
    _free(torch)
    return out


# ----------------------------------------------------- one architecture
def _describe(cfg) -> str:
    parts = [f"{cfg.num_layers} layers", f"d {cfg.d_model}"]
    if cfg.num_heads:
        parts.append(f"{cfg.num_heads}/{cfg.num_kv_heads} heads, hd "
                     f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}")
    if cfg.ssm_state:
        parts.append(f"SSM {cfg.ssm_heads} heads x {cfg.ssm_head_dim}, "
                     f"state {cfg.ssm_state}, chunk {cfg.ssm_chunk}")
    if cfg.attn_every:
        parts.append(f"shared attention block every {cfg.attn_every} "
                     "layers")
    if cfg.uses_moe:
        parts.append(f"MoE every {cfg.moe_every} layer(s): "
                     f"{cfg.num_experts} experts, top-{cfg.num_experts_per_tok}"
                     f", capacity factor {cfg.capacity_factor}"
                     + (", a shared expert" if cfg.moe_shared_expert else ""))
    parts.append(f"vocab {cfg.vocab_size}")
    return ", ".join(parts)


def serve_arch(torch, F, ops, ref, cfg) -> dict:
    """Every served phase of one architecture at full width, bf16 weights
    from ``SEED``: drain mode (counted), the kernel path against the einsum
    path, the control loop (counted, sync-checked), the step times and the
    control loop's oracles. granite-3-8b also runs the masked fleet write,
    the GPSO plan times and its kernels' times at its shapes. Returns what
    later phases read (launches, shapes, slab rows, kernel rows)."""
    from repro_torch.data.pipeline import prompt_workload
    from repro_torch.models.model import make_model

    dense = cfg.family == "dense"
    model = make_model(cfg)
    # full width cut to 2 layers, f32: the exact-parity checks' model (the
    # hybrid's shared block still runs: before layer 0)
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    model2 = make_model(cfg2)
    small = (cfg2, model2, model2.init(seed=SEED, dtype=torch.float32,
                                       device="cuda"))
    t0 = time.perf_counter()
    params = model.init(seed=SEED, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    log(f"[model] {cfg.name}: {_describe(cfg)}; "
        f"{cfg.param_count() / 1e9:.2f} B params in bf16, random from seed "
        f"{SEED}, built in {time.perf_counter() - t0:.1f}s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    workload = prompt_workload(cfg.vocab_size, N_REQUESTS, seed=SEED,
                               max_len=MAX_PROMPT, max_new=MAX_NEW)
    reps, _, shapes = phase_serve(torch, ops, cfg, model, params, workload)
    phase_paths(torch, cfg, model, params, workload, small)
    if dense:
        phase_fleet_write(torch, small)
    control = phase_control(torch, ops, cfg, model, params,
                            plan_times=cfg.name == SERVED[0])
    phase_block(torch, ops, cfg, model, params, control, small)
    if cfg.name == SERVED[-1]:
        phase_federation(torch, ops, cfg, model, params)
    if cfg.name == SERVED[0]:
        phase_balance_ab(torch, ops, cfg, model, params, control)
    rows = phase_times(torch, F, ops, ref, cfg, reps, workload, shapes,
                       control) if cfg.name == SERVED[0] else {}
    phase_step_times(torch, cfg, model, params, reps, workload)
    oracle = phase_oracles(torch, cfg, model, params, control, small)
    mesh = phase_mesh(torch, ops, ref, cfg, model, params, control, small,
                      oracle) if cfg.name == SERVED[0] else None
    if mesh is not None:
        mesh["model_axis"] = phase_model_axis(torch, F, ops, ref, cfg, model,
                                              params, control, small, oracle,
                                              mesh)
        mesh["replicated_axis"] = phase_replicated_axis(
            torch, ops, cfg, model, params, small, mesh)
    model_axis = phase_model_axis_ssm(torch, ops, cfg, small, oracle) \
        if cfg.name in SSM_ARCHS else None
    del reps
    _free(torch)
    chunk = phase_chunk(torch, ops, cfg, model, params, workload, small) \
        if cfg.name in CHUNK_ARCHS else None
    int8 = phase_int8(torch, ops, cfg, model, params, workload, small,
                      control) if cfg.name == SERVED[0] else None
    return {"launches": control["launches"], "rows": rows,
            "drain_shapes": shapes, "control_shapes": control["shapes"],
            "slab_rows": control["rows"], "chunk": chunk, "int8": int8,
            "mesh": mesh, "model_axis": model_axis}


def _largest(shapes, kind):
    """(K, bucket) of the largest prefill of ``kind`` in a run's shapes."""
    return max(((s[1], s[2]) for s in shapes if s[0] == kind),
               key=lambda s: s[0] * s[1])


def _time_ssd(torch, ops, ref, gen, cfg, B, T, label) -> dict:
    """ssd_scan at (B prompts, T steps) of ``cfg``'s heads: kernel and
    plain times, and the bound. Operations: the blocked algorithm at a
    block of 64 with C.B^T shared across heads and only its causal half --
    per block of q steps and batch row, q(q+1)/2 N for C.B^T, and per head
    q(q+1)/2 P for the diagonal term, q P N for the state's contribution
    to y and q P N for the state update (multiply-adds, 2 operations
    each). The kernel runs them as three TF32 tensor-core passes, so the
    bound's operations side is 3 x operations / 495 TFLOP/s; the f32 SIMT
    bound (operations / 67 TFLOP/s, PR 13's and PR 14's) is printed
    beside it. Bytes: x in, y out, a, B, C in, the final state out, f32.
    No single PyTorch call computes the scan."""
    from repro_torch.kernels import ssd_scan as ssd

    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    x, a, bm, cm = _ssd_inputs(torch, gen, B, T, H, P, N)
    chunk = min(cfg.ssm_chunk, T)
    n = 10 if B * T <= 1024 else 3
    ms = _graph_ms(torch, lambda: [ops.ssd_scan(x, a, bm, cm, chunk=chunk)
                                   for _ in range(n)], n)
    plain = _graph_ms(torch, lambda: [ref.ssd_scan_ref(x, a, bm, cm, chunk)
                                      for _ in range(n)], n)
    fma = 0
    for t0 in range(0, T, SSD_OPS_BLOCK):
        q = min(SSD_OPS_BLOCK, T - t0)
        tri = q * (q + 1) // 2
        fma += tri * N + H * (tri * P + 2 * q * P * N)
    flops = 2 * B * fma
    nbytes = 4 * (2 * B * T * H * P + B * T * H + 2 * B * T * N
                  + B * H * P * N)
    bound, by = _bound(nbytes, SSD_PASSES * flops, TF32_FLOPS_PER_S)
    simt, simt_by = _bound(nbytes, flops, F32_FLOPS_PER_S)
    tile, hpb = ssd.device_plan(B, T, H, N, "cuda")
    log(f"[times] ssd_scan {cfg.name} {label} B={B} T={T} H={H} P={P} N={N} "
        f"chunk={chunk} tile={tile} hpb={hpb} f32: kernel {ms:.4f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s of the algorithm's operations), "
        f"plain {plain:.4f} ms, library none, bound {bound:.4f} ms ({by}: "
        f"{nbytes} B, {SSD_PASSES} x {flops} flop at TF32; f32 SIMT bound "
        f"{simt:.4f} ms, {simt_by})")
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=None)


def phase_times_ssm(torch, F, ops, ref, served) -> dict:
    """ssd_scan at both ssm archs' largest control-loop fleet prefill and
    largest drain-mode bucket (the JSON row: mamba2-1.3b's control loop),
    and the attention kernels at head dim 80, zamba2-2.7b's shared block,
    at its control loop's and drain mode's shapes."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import prompt_workload
    from repro_torch.models.ssm_lm import n_invocations

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = {}
    for name in SSM_ARCHS:
        cfg, run = get_config(name), served[name]
        for label, (B, T) in (
                ("control fleet prefill",
                 _largest(run["control_shapes"], "afleet_prefill")),
                ("drain", _largest(run["drain_shapes"], "bucketed"))):
            r = _time_ssd(torch, ops, ref, gen, cfg, B, T, label)
            if name == SSM_ARCHS[0] and label.startswith("control"):
                rows["ssd_scan"] = r
    cfg, run = get_config("zamba2-2.7b"), served["zamba2-2.7b"]
    G, hd, n_inv = cfg.num_kv_heads, cfg.resolved_head_dim, n_invocations(cfg)
    qpg = cfg.num_heads // G
    bf = torch.bfloat16
    workload = prompt_workload(cfg.vocab_size, N_REQUESTS, seed=SEED,
                               max_len=MAX_PROMPT, max_new=MAX_NEW)
    drain_pos = torch.tensor([min(len(w["prompt"]) + MAX_NEW // 2,
                                  MAX_SEQ - 1) for w in workload[:MAX_BATCH]],
                             dtype=torch.int32, device="cuda")
    n = run["slab_rows"]
    for label, B, S, pos in (
            ("zamba2 control slab", n, CONTROL_MAX_SEQ,
             _ragged_pos(torch, gen, n, *CONTROL_DEPTH)),
            ("zamba2 drain", MAX_BATCH, MAX_SEQ, drain_pos)):
        slab = torch.randn((2, n_inv, B, S, G, hd), generator=gen,
                           device="cuda").to(bf)
        q = torch.randn(B, G, qpg, hd, generator=gen, device="cuda").to(bf)
        _time_decode(torch, F, ops, ref, q, [(slab[0, i], slab[1, i])
                                             for i in range(n_inv)], pos,
                     label)
        del slab
    for label, (kb, sb) in (
            ("zamba2 control fleet prefill",
             _largest(run["control_shapes"], "afleet_prefill")),
            ("zamba2 drain", _largest(run["drain_shapes"], "bucketed"))):
        _time_attention(torch, F, ops, ref, gen, kb, sb, G, qpg, hd, label)
    return rows


# ------------------------------------------------------------- the MoE family
class _Routes:
    """While entered, records the experts each MoE layer routes every token
    to (a wrapper of ``models.moe.route``), one (B, S, k) tensor a layer a
    forward, in call order. Given ``force`` (such a record of another
    run), each call routes as that run did instead: the recorded experts,
    with their gates renormalised from this run's own probabilities."""

    def __init__(self, force=None):
        from repro_torch.models import moe
        self.moe, self.calls, self.force = moe, [], force

    def __enter__(self):
        route = self.orig = self.moe.route
        forced = iter(self.force) if self.force is not None else None

        def recorded(router, x, k):
            probs, top_p, top_i = route(router, x, k)
            if forced is not None:
                top_i = next(forced)
                top_p = probs.gather(-1, top_i)
                top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
            self.calls.append(top_i)
            return probs, top_p, top_i
        self.moe.route = recorded
        return self

    def __exit__(self, *exc):
        self.moe.route = self.orig


def phase_moe_paths(torch, cfg, model, params, workload, dtype,
                    tol) -> None:
    """Kernel path against einsum path on an MoE model, counting routing.
    The prefill runs 8 workload prompts (bucketed, ``lengths`` marking the
    real tokens) through each path, recording every layer's top-k set a
    token; then both paths decode the einsum prefill's token from a copy
    of the einsum prefill's cache. A token whose top-k set differs between
    the paths runs other experts: its FFN output is a different function,
    not a rounding of the same one, and through attention it reaches every
    later token of its row. So the flips are counted and the logit gap is
    reported over every row and over the rows whose every real token
    routes alike in every layer; the gate is a third run, the kernel path
    routed as the einsum path routed (each layer given the einsum run's
    experts, its gates from its own probabilities), whose every row is
    held to ``tol``. In f32 the rounding between the paths is far below
    any router margin: the free run's every row is held to ``tol`` too."""
    batch = _bucket([w["prompt"] for w in workload[:MAX_BATCH]], "cuda",
                    torch)
    B, S = batch["tokens"].shape
    real = torch.arange(S, device="cuda")[None, :] < batch["lengths"][:, None]
    runs = (("einsum", "einsum", False), ("pallas", "pallas", False),
            ("forced", "pallas", True))
    out = {}
    for name, backend, force in runs:
        with _Routes(out["einsum"][1] if force else None) as routes:
            logits, cache, _ = model.prefill(
                params, batch, cache_len=MAX_SEQ, cache_dtype=dtype,
                attn_backend=backend)
        out[name] = [logits.float(), routes.calls]
        if name == "einsum":
            base, tok = cache, torch.argmax(logits, dim=-1)[:, None].to(
                torch.int32)
        del cache
    pos = batch["lengths"].to(torch.int32)
    for name, backend, force in runs:
        with _Routes(out["einsum"][3] if force else None) as routes:
            dlogits, _ = model.decode(
                params, {k: v.clone() for k, v in base.items()}, tok, pos,
                attn_backend=backend)
        out[name] += [dlogits.float(), routes.calls]
    del base
    label = str(dtype).removeprefix("torch.")
    for i, what in ((0, "prefill last-token"), (2, "first decode")):
        e = out["einsum"][i]
        scale = e.abs().max()
        flip = (torch.stack(out["pallas"][i + 1]).sort(-1).values
                != torch.stack(out["einsum"][i + 1]).sort(-1).values
                ).any(-1)                                  # (L, B, S)
        if i == 0:
            flip = flip & real
        n_pairs = int((real if i == 0 else flip.new_ones(B, 1)).sum()) \
            * flip.shape[0]
        agree = ~flip.any(dim=0).any(dim=-1)               # (B,)
        gap = {n: ((out[n][i] - e) / scale).abs() for n in ("pallas",
                                                           "forced")}
        alike = gap["pallas"][agree].max().item() if agree.any() else None
        free, forced = gap["pallas"].max().item(), gap["forced"].max().item()
        log(f"[paths] {cfg.name} {label} full width, {cfg.num_layers} "
            f"layers, {what}: top-k sets differing between the paths "
            f"{int(flip.sum())} of {n_pairs} (token, layer) pairs, rows "
            f"routing alike {int(agree.sum())}/{B}; max|kernel-einsum| / "
            f"max|einsum| over every row {free:.3e}, over the rows routing "
            f"alike {'none' if alike is None else f'{alike:.3e}'}; the "
            f"kernel path routed as the einsum path: {forced:.3e} "
            f"(tolerance {tol}); argmax agreement "
            f"{(out['pallas'][i].argmax(-1) == e.argmax(-1)).float().mean().item():.3f}")
        worst = max(forced, free) if dtype == torch.float32 else forced
        if not worst <= tol:
            raise AssertionError(f"{cfg.name} {what} logits differ by "
                                 f"{worst:.3e} > {tol}")
    del out
    torch.cuda.empty_cache()


def phase_moe_f32(torch, cfg, workload) -> None:
    """grok-1-314b at full width cut to ``MOE_F32_DEPTH`` layers in f32:
    the kernel path against the einsum path (logits, every row, at
    ``F32_PATH_TOL``) and identical drain-mode streams, kernel, einsum and
    eager steps."""
    from repro_torch.models.model import make_model

    cfg1 = dataclasses.replace(cfg, num_layers=MOE_F32_DEPTH)
    model1 = make_model(cfg1)
    params1 = model1.init(seed=SEED, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    log(f"[model] {cfg1.name} f32 at {MOE_F32_DEPTH} layer: "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    phase_moe_paths(torch, cfg1, model1, params1, workload, torch.float32,
                    F32_PATH_TOL)
    phase_streams(torch, cfg1, (cfg1, model1, params1), workload)
    del params1
    _free(torch)


def _param_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_param_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_param_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def phase_moe_times(torch, F, ops, ref, cfg, model, params, reps, workload,
                    smi) -> dict:
    """The ``[moe]`` line: the decode step (``MAX_BATCH`` slots at the
    drain mode's depths) on the device, split into its MoE layers
    (``moe_apply`` alone on the step's (B, 1, d) input, replayed from a
    graph) and the rest; the expert weights' bytes a step (the reference
    runs every expert densely, so a step reads them all) against their
    bound at 3.35 TB/s; one single admit's prefill (the workload's longest
    prompt, as the engine admits it) on the host clock and the device;
    the peak device memory of the model's phases. Then the attention
    kernels at this model's heads: flash_decode over the drain pool and
    flash_attention at that prefill's shape, against plain, SDPA and the
    bound; returns their rows."""
    from repro_torch.models import moe

    bf = torch.bfloat16
    pos = torch.tensor([min(len(w["prompt"]) + MAX_NEW // 2, MAX_SEQ - 1)
                        for w in workload[:MAX_BATCH]], dtype=torch.int32,
                       device="cuda")
    tok = torch.ones((MAX_BATCH, 1), dtype=torch.int32, device="cuda")
    pool = reps[0].cache
    step_ms = _graph_ms(torch, lambda: model.decode(params, pool, tok, pos),
                        1, reps=5)
    layers = [lp["moe"] for lp in params["layers"] if "moe" in lp]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    x = torch.randn(MAX_BATCH, 1, cfg.d_model, generator=gen,
                    device="cuda").to(bf)
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.num_experts_per_tok,
              capacity_factor=cfg.capacity_factor, activation=cfg.activation)
    moe_ms = _graph_ms(torch, lambda: [moe.moe_apply(p, x, **kw)
                                       for p in layers], 1, reps=5)
    experts = sum(_param_bytes({k: p[k] for k in ("w_gate", "w_up", "w_down")
                                if k in p}) for p in layers)
    shared = sum(_param_bytes(p.get("shared", {})) for p in layers)
    bound = (experts + shared) / HBM_BYTES_PER_S * 1e3
    prompt = max((w["prompt"] for w in workload), key=len)
    batch = {"tokens": torch.tensor([prompt], dtype=torch.int32,
                                    device="cuda")}

    def prefill():
        logits, _, _ = model.prefill(params, batch, cache_len=len(prompt),
                                     cache_dtype=bf)
        return torch.argmax(logits, dim=-1).cpu()

    prefill()
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill()
        host.append((time.perf_counter() - t0) * 1e3)
    prefill_dev = _graph_ms(torch, lambda: model.prefill(
        params, batch, cache_len=len(prompt), cache_dtype=bf), 1, reps=3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[moe] {cfg.name}, {cfg.num_layers} layers ({len(layers)} MoE), "
        f"{smi}: decode step, {MAX_BATCH} slots, device {step_ms:.2f} ms "
        f"(CUDA-graph replay, median of 5): MoE layers {moe_ms:.2f} ms, the "
        f"rest {step_ms - moe_ms:.2f} ms; expert weights a step "
        f"{experts / 1e9:.2f} GB (+ shared expert {shared / 1e9:.3f} GB), "
        f"bound {bound:.2f} ms at 3.35 TB/s: the MoE layers take "
        f"{moe_ms / bound:.2f}x it; single-admit prefill of {len(prompt)} "
        f"tokens: host {statistics.median(host):.2f} ms (median of 3, to "
        f"its first token), device {prefill_dev:.2f} ms (CUDA-graph replay, "
        f"median of 3); peak device memory {peak:.1f} GiB")

    G, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    qpg = cfg.num_heads // G
    q = torch.randn(MAX_BATCH, G, qpg, hd, generator=gen,
                    device="cuda").to(bf)
    return {"flash_decode": _time_decode(
        torch, F, ops, ref, q, [(pool["k"][li], pool["v"][li])
                                for li in range(cfg.num_layers)], pos,
        f"{cfg.name} drain"),
        "flash_attention": _time_attention(
            torch, F, ops, ref, gen, 1, len(prompt), G, qpg, hd,
            f"{cfg.name} single admit")}


def serve_moe(torch, F, ops, ref, cfg_full, smi) -> dict:
    """One MoE architecture at full width, depth cut (``MOE_DEPTH``), bf16
    weights from ``SEED``: drain mode (counted: flash_attention once a
    layer a single admit, flash_decode once a layer a step), the ``[moe]``
    line and the attention kernels' times at its heads. grok-1-314b also
    runs the kernel path against the einsum path (f32 at 1 layer, gated,
    with identical drain streams; bf16 at full depth, routing flips
    counted) and the control loop of phase 6 with its checks. Returns the
    launch counts and kernel rows."""
    from repro_torch.data.pipeline import prompt_workload
    from repro_torch.models.model import make_model

    cfg = dataclasses.replace(cfg_full, num_layers=MOE_DEPTH[cfg_full.name])
    torch.cuda.reset_peak_memory_stats()
    workload = prompt_workload(cfg.vocab_size, N_REQUESTS, seed=SEED,
                               max_len=MAX_PROMPT, max_new=MAX_NEW)
    grok = cfg.name == MOE_ARCHS[0]
    if grok:
        phase_moe_f32(torch, cfg, workload)
    model = make_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=SEED, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    log(f"[model] {cfg.name}: {_describe(cfg)}; depth cut from "
        f"{cfg_full.num_layers} layers; {cfg.param_count() / 1e9:.2f} B "
        f"params, {_param_bytes(params) / 1e9:.1f} GB in bf16, random from "
        f"seed {SEED}, built in {time.perf_counter() - t0:.1f}s; device "
        f"memory {torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    reps, drain, _ = phase_serve(torch, ops, cfg, model, params, workload)
    out = {"drain": drain, "cfg": cfg}
    if grok:
        phase_moe_paths(torch, cfg, model, params, workload, torch.bfloat16,
                        BF16_PATH_TOL)
        out["control"] = phase_control(torch, ops, cfg, model, params)
    out.update(phase_moe_times(torch, F, ops, ref, cfg, model, params, reps,
                               workload, smi))
    del reps, params
    _free(torch)
    return out


# ----------------------------------------------------------------- phase 11
# the control plane's training and the paper's experiment over the fluid
# simulator. The DDPG update's GCN layers: Bt = ClusterConfig.batch_size
# graphs of the experiment's 8 nodes and the paper's 16, F = 4 + horizon 32
# into gcn_hidden 64 (relu), then 64 into 64 (none)
BWD_BATCH = 128
BWD_NODES = (8, 16)
BWD_LAYERS = ((36, 64, True), (64, 64, False))
UPDATE_TOL = dict(atol=1e-4, rtol=1e-4)   # card against CPU, whole update
EPISODE_RTOL = 1e-5                        # card against CPU, per tick
EXPERIMENT_TICKS, TRAIN_TICKS, TRAIN_EPISODES = 400, 400, 4


def _update_launches(n_layers: int, fused_target: bool) -> tuple:
    """(gcn_layer, gcn_layer_bwd) launches of one ``ddpg_update`` (derived
    from its code): the target action (one fused launch, else L layered),
    the target, online and actor-loss critics and the actor's layered
    action (L each); L backward launches for the critic's gradient and L
    for the actor's."""
    return (1 if fused_target else n_layers) + 4 * n_layers, 2 * n_layers


def _bwd_chain(torch, a, x, w, out, dh, relu, need_dx):
    """One layer's backward as a chain of ``torch.matmul`` calls: the
    library yardstick (the port never calls it)."""
    g = dh * (out > 0) if relu else dh
    f, h = w.shape
    dw = torch.matmul(a, x).reshape(-1, f).T @ g.reshape(-1, h)
    db = g.sum(dim=(0, 1))
    dx = torch.matmul(a.T, g @ w.T) if need_dx else None
    return dx, dw, db


def _bwd_bound(n, f, h, relu, need_dx):
    """Bytes (each input read once -- A_hat, X, W, dH and, with the relu,
    H -- each output written once) and operations (A_hat.X, dW, db, the
    relu's mask, and for dX G.W^T and A_hat^T.(G.W^T)) of one backward of
    BWD_BATCH graphs."""
    bt = BWD_BATCH
    nbytes = 4 * (n * n + bt * n * f + f * h + bt * n * h * (2 if relu
                                                               else 1)
                  + f * h + h + (bt * n * f if need_dx else 0))
    flops = 2 * bt * n * n * f + 2 * bt * n * f * h + bt * n * h \
        + (bt * n * h if relu else 0) \
        + ((2 * bt * n * h * f + 2 * bt * n * n * f) if need_dx else 0)
    return nbytes, flops


def phase_bwd(torch, ops, ref, gen) -> dict:
    """(a) gcn_layer_bwd against its plain version (autograd through
    ``ref.gcn_layer_ref``) at the update's shapes: N 8 and 16, the layers
    36 -> 64 with relu and 64 -> 64 without, dX on and off, f32 within
    GCN_TOL; two launches on the same inputs must agree bit for bit (the
    batch sums have a fixed order). Then the times of one GCN's backward as
    the update runs it (the first layer without dX, its input being the
    observation; the second with): kernel, plain version, the matmul chain,
    bound. Returns the JSON row (at N 16) and the worst error."""
    from repro_torch.core.gcn import make_topology, normalize_adjacency

    worst, row = 0.0, {}
    for n in BWD_NODES:
        a = torch.from_numpy(normalize_adjacency(make_topology(n))).cuda()
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0, flops=0)
        for f, h, relu in BWD_LAYERS:
            x = torch.randn((BWD_BATCH, n, f), generator=gen, device="cuda")
            if not relu:                  # the second layer reads relu(h1)
                x = torch.relu(x)
            w = torch.randn((f, h), generator=gen, device="cuda") \
                * (2.0 / f) ** 0.5
            b = 0.1 * torch.randn((h,), generator=gen, device="cuda")
            out = ops.gcn_layer(a, x, w, b, relu=relu)
            dh = torch.randn(out.shape, generator=gen, device="cuda") \
                / BWD_BATCH
            for need_dx in (False, True):
                args = (a, x, w, b, out, dh)
                got = ops.gcn_layer_bwd(*args, relu=relu, need_dx=need_dx)
                again = ops.gcn_layer_bwd(*args, relu=relu, need_dx=need_dx)
                want = ref.gcn_layer_bwd_ref(a, x, w, b, dh, relu=relu,
                                             need_dx=need_dx)
                torch.cuda.synchronize()
                errs = []
                for name, g, g2, wt in zip(("dx", "dw", "db"), got, again,
                                           want):
                    if wt is None:
                        if g is not None:
                            raise AssertionError("gcn_layer_bwd: dx given "
                                                 "unasked")
                        continue
                    torch.testing.assert_close(
                        g, wt, **GCN_TOL,
                        msg=lambda m: f"gcn_layer_bwd {n} {f}->{h} {name}: "
                                      f"{m}")
                    if not torch.equal(g, g2):
                        raise AssertionError(f"gcn_layer_bwd {n} {f}->{h} "
                                             f"{name}: two launches differ")
                    errs.append((g - wt).abs().max().item())
                worst = max(worst, *errs)
                log(f"[parity] gcn_layer_bwd Bt={BWD_BATCH} N={n} {f}->{h} "
                    f"relu={relu} dX={need_dx} f32: max|err| "
                    f"{max(errs):.3e} (atol/rtol {GCN_TOL['atol']}); "
                    f"deterministic")
            need_dx = not relu          # as the update runs the layer
            n_in = 20
            kw = dict(relu=relu, need_dx=need_dx)
            ms = _graph_ms(torch, lambda: [ops.gcn_layer_bwd(
                a, x, w, b, out, dh, **kw) for _ in range(n_in)], n_in)
            plain = _graph_ms(torch, lambda: [ref.gcn_layer_bwd_ref(
                a, x, w, b, dh, **kw) for _ in range(n_in)], n_in)
            lib = _graph_ms(torch, lambda: [_bwd_chain(
                torch, a, x, w, out, dh, relu, need_dx)
                for _ in range(n_in)], n_in)
            nbytes, flops = _bwd_bound(n, f, h, relu, need_dx)
            bound, by = _bound(nbytes, flops, F32_FLOPS_PER_S)
            log(f"[times] gcn_layer_bwd Bt={BWD_BATCH} N={n} {f}->{h} "
                f"relu={relu} dX={need_dx}: kernel {ms:.4f} ms, plain "
                f"{plain:.4f}, matmul chain {lib:.4f}, bound {bound:.6f} "
                f"({by}: {nbytes} B, {flops} flop)")
            for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("nbytes", nbytes), ("flops", flops)):
                tot[k] += v
        bound, by = _bound(tot["nbytes"], tot["flops"], F32_FLOPS_PER_S)
        row = dict(ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=bound,
                   bound_by=by, library_ms=tot["library_ms"],
                   timed_at=f"one GCN's backward in the update: Bt "
                            f"{BWD_BATCH}, N {n}, 36->64 relu without dX "
                            f"+ 64->64 with dX (two launches)")
        log(f"[times] gcn_layer_bwd, one GCN's backward (2 launches) at "
            f"N={n}: kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f}, "
            f"matmul chain {tot['library_ms']:.4f}, bound {bound:.6f} "
            f"({by})")
    return row, worst


def _fwd_chain(torch, a, x, w, b, relu):
    """One layer's forward as ``torch.matmul`` and ``torch.addmm``: the
    library yardstick (the port never calls it)."""
    f, h = w.shape
    y = torch.addmm(b, torch.matmul(a, x).reshape(-1, f), w)
    return (torch.relu(y) if relu else y).reshape(*x.shape[:-1], h)


def phase_update_fwd(torch, ops, ref, gen) -> dict:
    """gcn_layer (the forward) at the DDPG update's shapes -- BWD_BATCH
    graphs of N nodes, 36 -> 64 with relu and 64 -> 64 without, two
    launches a GCN, ``_update_launches`` GCNs' worth an update -- against
    its plain version (within GCN_TOL), the matmul/addmm chain and the
    bound. Returns {N: row} for the kernels line."""
    from repro_torch.core.gcn import make_topology, normalize_adjacency

    out = {}
    per_update = _update_launches(2, True)[0]
    for n in BWD_NODES:
        a = torch.from_numpy(normalize_adjacency(make_topology(n))).cuda()
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0, flops=0)
        for f, h, relu in BWD_LAYERS:
            x = torch.randn((BWD_BATCH, n, f), generator=gen, device="cuda")
            w = torch.randn((f, h), generator=gen, device="cuda") \
                * (2.0 / f) ** 0.5
            b = 0.1 * torch.randn((h,), generator=gen, device="cuda")
            torch.testing.assert_close(
                ops.gcn_layer(a, x, w, b, relu=relu),
                ref.gcn_layer_ref(a, x, w, b, relu=relu), **GCN_TOL)
            n_in = 20
            ms = _graph_ms(torch, lambda: [ops.gcn_layer(a, x, w, b,
                                                         relu=relu)
                                           for _ in range(n_in)], n_in)
            plain = _graph_ms(torch, lambda: [ref.gcn_layer_ref(
                a, x, w, b, relu=relu) for _ in range(n_in)], n_in)
            lib = _graph_ms(torch, lambda: [_fwd_chain(torch, a, x, w, b,
                                                       relu)
                                            for _ in range(n_in)], n_in)
            bt = BWD_BATCH
            nbytes = 4 * (n * n + bt * n * f + f * h + h + bt * n * h)
            flops = 2 * bt * n * n * f + 2 * bt * n * f * h + bt * n * h \
                * (2 if relu else 1)
            for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("nbytes", nbytes), ("flops", flops)):
                tot[k] += v
        bound, by = _bound(tot["nbytes"], tot["flops"], F32_FLOPS_PER_S)
        out[n] = dict(ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=bound,
                      bound_by=by, library_ms=tot["library_ms"],
                      launches_per_update=per_update,
                      timed_at=f"one GCN's forward in the update: Bt "
                               f"{BWD_BATCH}, N {n}, 36->64 relu + 64->64 "
                               "(two launches)")
        log(f"[times] gcn_layer at the update's shapes, one GCN (2 launches;"
            f" {per_update} launches an update) at Bt={BWD_BATCH} N={n}: "
            f"kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f}, "
            f"matmul/addmm chain {tot['library_ms']:.4f}, bound {bound:.6f} "
            f"({by}: {tot['nbytes']} B, {tot['flops']} flop)")
    return out


def _np_batch(n, feat, batch, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((batch, n, feat)).astype(np.float32)
    nxt = rng.standard_normal((batch, n, feat)).astype(np.float32)
    act = rng.dirichlet(np.ones(n), batch).astype(np.float32)
    rew = rng.uniform(-2.0, 0.0, batch).astype(np.float32)
    mask = (rng.random((batch, n)) > 0.1).astype(np.float32)
    return obs, act, rew, nxt, mask


def phase_update(torch, ops) -> None:
    """(b) One ``ddpg_update`` on the card against the same update on the
    CPU, from one state (the paper's ClusterConfig(): 16 nodes, horizon 32,
    batch 128) and one batch: every leaf of the four trees and both losses
    within UPDATE_TOL; the update's launches as derived. Then one update's
    host ms (enqueue; to the results), device ms (a CUDA-graph replay of
    the same update: busy time only) and idle share."""
    from repro_torch.configs.paper_cluster import ClusterConfig
    from repro_torch.core import ddpg
    from repro_torch.core.gcn import make_topology, normalize_adjacency
    from repro_torch.core.tree import leaves, tree_map

    cfg = ClusterConfig()
    n, feat = cfg.num_nodes, 4 + cfg.horizon
    state = ddpg.init_ddpg(torch.Generator().manual_seed(SEED), feat, cfg)
    cpu = (state.actor, state.critic, state.actor_target,
           state.critic_target)
    card = tuple(tree_map(lambda t: t.cuda(), tr) for tr in cpu)
    a_hat = torch.from_numpy(normalize_adjacency(make_topology(
        n, cfg.topology)))
    batch = tuple(torch.from_numpy(v) for v in _np_batch(
        n, feat, cfg.batch_size, SEED))
    hyper = dict(gamma=cfg.gamma, tau=cfg.tau, actor_lr=cfg.actor_lr,
                 critic_lr=cfg.critic_lr, fused_target=True)
    want, wm = ddpg.ddpg_update(cpu, a_hat, batch, **hyper)
    a_card = a_hat.cuda()
    b_card = tuple(v.cuda() for v in batch)
    ops.reset_launches()
    got, gm = ddpg.ddpg_update(card, a_card, b_card, **hyper)
    torch.cuda.synchronize()
    fwd, bwd = _update_launches(len(state.actor["gcn"]["w"]), True)
    if (ops.LAUNCHES["gcn_layer"], ops.LAUNCHES["gcn_layer_bwd"]) != \
            (fwd, bwd):
        raise AssertionError(f"ddpg_update launches {dict(ops.LAUNCHES)}, "
                             f"expected gcn_layer {fwd}, bwd {bwd}")
    worst = 0.0
    for g_tree, w_tree, name in zip(got, want, ("actor", "critic",
                                                "actor_target",
                                                "critic_target")):
        for g, w in zip(leaves(g_tree), leaves(w_tree)):
            torch.testing.assert_close(
                g.cpu(), w, **UPDATE_TOL,
                msg=lambda m: f"ddpg_update {name}: {m}")
            worst = max(worst, (g.cpu() - w).abs().max().item())
    for k in wm:
        torch.testing.assert_close(gm[k].cpu(), wm[k], **UPDATE_TOL)
    enq, done = [], []
    for _ in range(11):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ddpg.ddpg_update(card, a_card, b_card, **hyper)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enq.append((t1 - t0) * 1e3)
        done.append((time.perf_counter() - t0) * 1e3)
    host = statistics.median(done[1:])
    dev = _graph_ms(torch, lambda: ddpg.ddpg_update(card, a_card, b_card,
                                                    **hyper), 1)
    log(f"[train] ddpg_update on the card against the CPU (16 nodes, F "
        f"{feat}, batch {cfg.batch_size}): max|err| over the four trees "
        f"{worst:.3e} (atol/rtol {UPDATE_TOL['atol']}); losses critic "
        f"{gm['critic_loss'].item():.5f} / {wm['critic_loss'].item():.5f}, "
        f"actor {gm['actor_loss'].item():.5f} / "
        f"{wm['actor_loss'].item():.5f}; launches gcn_layer {fwd}, "
        f"gcn_layer_bwd {bwd}; host {statistics.median(enq[1:]):.2f} ms to "
        f"enqueue, {host:.2f} ms to the results, device busy {dev:.3f} ms "
        f"(CUDA-graph replay; medians of 10): idle share "
        f"{1 - dev / host:.3f}")


def phase_episode(torch) -> None:
    """(c) An RRA episode of EXPERIMENT_TICKS ticks at 8 nodes with the
    sim's tick on the card against the same episode on the CPU: every
    tick's utilization, response, served and fairness within EPISODE_RTOL,
    the replicas equal, one readback of the sim a tick."""
    from repro_torch.configs.paper_cluster import ClusterConfig
    from repro_torch.sim.experiment import jain_fairness, make_plane
    from repro_torch.workload.trace import TraceConfig, generate_trace

    cfg = ClusterConfig(num_nodes=8)
    trace = generate_trace(TraceConfig(ticks=EXPERIMENT_TICKS), seed=0,
                           load_scale=1.8)
    planes = [make_plane(cfg, trace, "RRA", unit_capacity=30.0, seed=1,
                         device=d) for d in ("cuda", "cpu")]
    worst = 0.0
    for t, rate in enumerate(trace["arrivals"]):
        mg, mc = (p.step(float(rate)) for p in planes)
        pairs = [(mg[k], mc[k]) for k in ("mean_utilization",
                                          "response_time", "served")]
        pairs.append((jain_fairness(mg["utilization"] + 1e-6),
                      jain_fairness(mc["utilization"] + 1e-6)))
        for g, c in pairs:
            rel = abs(g - c) / max(abs(c), 1e-12)
            worst = max(worst, rel)
            if rel > EPISODE_RTOL and abs(g - c) > 1e-9:
                raise AssertionError(f"RRA episode tick {t}: card {g} cpu "
                                     f"{c}")
        if (mg["active_replicas"] != mc["active_replicas"]).any():
            raise AssertionError(f"RRA episode tick {t}: replicas differ")
    sim = planes[0].backend.sim
    if sim.fetches != EXPERIMENT_TICKS:
        raise AssertionError(f"sim fetches {sim.fetches}")
    log(f"[sim] RRA episode, 8 nodes, {EXPERIMENT_TICKS} ticks, the tick "
        f"on the card against the CPU: max relative difference {worst:.2e} "
        f"(tolerance {EPISODE_RTOL}), replicas equal every tick; "
        f"{sim.fetches} readbacks of the sim")


def _tick_ms(res) -> str:
    ms = sorted(res.tick_s * 1e3)
    return (f"{statistics.median(ms):.2f} / "
            f"{ms[int(0.95 * (len(ms) - 1))]:.2f}")


def phase_experiment(torch, ops) -> dict:
    """(d) The experiment at its defaults (``sim.experiment.experiment``,
    the entry point of ``python -m repro_torch.sim.experiment``): the GRU
    forecaster's training, the balancer's (TRAIN_EPISODES episodes of
    TRAIN_TICKS), one episode a method, the table. Counts zeroed just
    before and read just after: gcn_layer once an OURS tick (the action,
    one fused launch) plus each update's, gcn_layer_bwd each update's.
    Every summary finite; OURS's mean response below RRA's. Then (e) one
    training episode of OURS at the paper's default cluster (16 nodes,
    horizon 32, batch 128), counted the same way, with its syncs a tick.
    Returns the launches, the updates and the forecaster's params."""
    import math

    from repro_torch.configs.paper_cluster import ClusterConfig
    from repro_torch.core.balancer import RLBalancer
    from repro_torch.sim.experiment import (collect_episode, experiment,
                                            make_plane)
    from repro_torch.workload.trace import TraceConfig, generate_trace

    ops.reset_launches()
    t0 = time.perf_counter()
    out = experiment(EXPERIMENT_TICKS, 1.8, "cuda", log=log)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    rl = out["rl"]
    updates = rl.fetches
    ticks = TRAIN_EPISODES * TRAIN_TICKS + EXPERIMENT_TICKS
    fused = rl.actor == "fused"
    fwd, bwd = _update_launches(len(rl.state.actor["gcn"]["w"]), fused)
    want = {"gcn_layer": ticks * (1 if fused else 2) + updates * fwd,
            "gcn_layer_bwd": updates * bwd}
    got = {k: launches[k] for k in want}
    if got != want or updates == 0:
        raise AssertionError(f"experiment launches {launches}, expected "
                             f"{want} ({ticks} OURS ticks, {updates} "
                             "updates)")
    summ = out["summaries"]
    if not all(math.isfinite(v) for s in summ.values() for v in s.values()):
        raise AssertionError(f"experiment: a summary is not finite {summ}")
    if not summ["OURS"]["mean_resp"] < summ["RRA"]["mean_resp"]:
        raise AssertionError("experiment: OURS's mean response "
                             f"{summ['OURS']['mean_resp']} not below RRA's "
                             f"{summ['RRA']['mean_resp']}")
    secs = out["seconds"]
    log(f"[sim] experiment: {total:.1f} s -- forecaster "
        f"{secs['forecaster']:.1f} s (300 steps: {secs['forecaster'] / 0.3:.1f}"
        f" ms a step; mse {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}),"
        f" balancer {secs['balancer']:.1f} s ({TRAIN_EPISODES} episodes, "
        f"{updates} updates), episodes {secs['episodes']:.1f} s; launches "
        f"gcn_layer {got['gcn_layer']} = {ticks} OURS ticks + {updates} x "
        f"{fwd}, gcn_layer_bwd {got['gcn_layer_bwd']} = {updates} x {bwd}")
    log("[sim] host ms a tick, p50 / p95: " + "; ".join(
        f"{m} {_tick_ms(r)}" for m, r in out["results"].items()))
    r, o = summ["RRA"], summ["OURS"]
    log(f"[sim] OURS against RRA: mean response {o['mean_resp']:.3f} / "
        f"{r['mean_resp']:.3f} s ({1 - o['mean_resp'] / r['mean_resp']:+.1%}"
        f" delay cut), scaling efficiency {o['scaling_efficiency']:.3f} / "
        f"{r['scaling_efficiency']:.3f}")

    # (e) a training episode at the paper's default cluster
    cfg = ClusterConfig()
    rl16 = RLBalancer(cfg, 4 + cfg.horizon, seed=SEED, device="cuda")
    trace = generate_trace(TraceConfig(ticks=TRAIN_TICKS), seed=0,
                           load_scale=1.8)
    plane = make_plane(cfg, trace, "OURS", unit_capacity=30.0, rl=rl16,
                       forecaster_params=out["forecaster"], train_rl=True,
                       explore=True, failures=False, seed=SEED,
                       device="cuda")
    ops.reset_launches()
    t0 = time.perf_counter()
    res = collect_episode(plane, trace["arrivals"], "OURS", cfg, 30.0)
    torch.cuda.synchronize()
    secs16 = time.perf_counter() - t0
    u16 = rl16.fetches
    fused16 = rl16.actor == "fused"
    fwd16, bwd16 = _update_launches(len(rl16.state.actor["gcn"]["w"]),
                                    fused16)
    want16 = {"gcn_layer": TRAIN_TICKS * (1 if fused16 else 2)
              + u16 * fwd16, "gcn_layer_bwd": u16 * bwd16}
    got16 = {k: ops.LAUNCHES[k] for k in want16}
    s16 = res.summary()
    if got16 != want16 or u16 == 0 or not all(
            math.isfinite(v) for v in s16.values()):
        raise AssertionError(f"training episode at 16 nodes: launches "
                             f"{got16}, expected {want16}; summary {s16}")
    sim = plane.backend.sim
    per = {"sim": sim.fetches, "plane": plane.fetches, "updates": u16}
    hs = {k: v / TRAIN_TICKS * 1e3 for k, v in plane.host_s.items()}
    log(f"[sim] OURS training episode, ClusterConfig() (16 nodes, horizon "
        f"{cfg.horizon}, batch {cfg.batch_size}), {TRAIN_TICKS} ticks: "
        f"{secs16:.1f} s, {u16} updates ({hs['learn'] * TRAIN_TICKS / u16:.2f}"
        f" host ms an update with its replay), actor {rl16.actor}; launches "
        f"{got16}; host ms a tick p50 / p95 {_tick_ms(res)} (forecast "
        f"{hs['forecast']:.2f}, balance {hs['balance']:.2f}, learn "
        f"{hs['learn']:.2f}, scale {hs['scale']:.2f}); syncs a tick "
        f"{sum(per.values()) / TRAIN_TICKS:.2f} ({per}: the sim's readback, "
        f"the plane's forecast, fractions and plans, one fetch of the "
        f"losses an update); mean resp {s16['mean_resp']:.3f}")
    return {"launches": got, "updates": updates, "ticks": ticks}


def phase_sim(torch, ops, ref) -> tuple:
    """Phase 11, (a)-(e). Returns the gcn_layer_bwd JSON row, its worst
    parity error, the experiment's launch counts and gcn_layer's rows at
    the update's shapes."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    row, err = phase_bwd(torch, ops, ref, gen)
    fwd = phase_update_fwd(torch, ops, ref, gen)
    phase_update(torch, ops)
    phase_episode(torch)
    exp = phase_experiment(torch, ops)
    return row, err, exp, fwd


# ----------------------------------------------------------------- phase 12
# the vlm and audio families at full width and depth, through the engine
# API with per-request extras (the reference's CLI reaches neither). max_seq
# 2048 holds internvl2-2b's longest request whole (1,025 patches + 511
# prompt tokens + 63 new), so the retirement that counts the patch prefix
# (pos >= max_seq - 1, the reference's rule) cuts no request; 448 is
# whisper's own decoder context (arXiv:2212.04356)
EXTRA_ARCHS = {"internvl2-2b": dict(max_seq=2048, max_prompt=512),
               "whisper-base": dict(max_seq=448, max_prompt=128)}
EXTRA_PATHS = 4        # requests of the f32 kernel-vs-einsum comparison
# the parity inputs' query scale: with unit q and k the scores have std ~1
# and the softmax spreads over ~Sk / e keys, so at 1,500 keys an output is
# ~0.035, no larger than the bf16 tolerance; at 3x the scores have std ~3,
# a few keys dominate and the outputs are O(1)
EXTRA_Q_SCALE = 3.0
# and rms(err) / rms(plain) at most this, in both dtypes: rounding the
# probabilities and the outputs to bf16 leaves a few 1e-3 of the rms, a
# tile of keys dropped or misplaced leaves 1e-2 to 1e-1
EXTRA_REL_TOL = 0.01


def _extras(cfg, n: int, seed: int) -> list:
    """``n`` requests' extras from a numpy RNG x 0.1 (f32 on the host; the
    engine stages them in the weights' dtype)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    name, length = (("patch_embeds", cfg.num_patches) if cfg.family == "vlm"
                    else ("frame_embeds", cfg.encoder_seq_len))
    return [{name: (0.1 * rng.standard_normal((1, length, cfg.d_model),
                                              dtype=np.float32))}
            for _ in range(n)]


def phase_parity_extras(torch, ops, ref, gen) -> dict:
    """Both attention kernels against their plain versions at this phase's
    new shapes, f32 and bf16: flash_attention over internvl2-2b's patch
    prefix and longest prompt (1,025 + 511, causal, 8 x 2 heads, hd 128),
    whisper-base's encoder (1,500 frames, full, 8 x 1, hd 64) and its
    decoder's cross-attention (127 queries over 1,500 keys, full); and
    flash_decode over internvl2-2b's pool (8 rows of 3,073 positions,
    ragged depths past the prefix) and whisper-base's self cache (8 x 448)
    and cross cache (8 x 1,500, every row at position 1,499). q is drawn
    at ``EXTRA_Q_SCALE`` so the outputs are O(1); each shape is held to
    the dtype's tolerance and its error's rms to ``EXTRA_REL_TOL`` of the
    plain output's."""
    errs = {"flash_decode": 0.0, "flash_attention": 0.0}

    def close(name, got, want, dname, what):
        err = _close(name, got, want, dname, torch)
        want = want.float()
        rel = ((got.float() - want).pow(2).mean().sqrt()
               / want.pow(2).mean().sqrt()).item()
        log(f"[parity] {name} {what} {dname}: max|err|={err:.3e} (atol/rtol "
            f"{TOLS[dname]['atol']}), rms(err) / rms(plain) = {rel:.3e} "
            f"(tolerance {EXTRA_REL_TOL}), max|plain| "
            f"{want.abs().max().item():.3f}")
        if not rel <= EXTRA_REL_TOL:
            raise AssertionError(f"{name} {what} {dname}: rms(err) / "
                                 f"rms(plain) = {rel:.3e}")
        errs[name] = max(errs[name], err)

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    attn = [((1, 1025 + 511, 8, 2, 128), 1025 + 511, True),
            ((1, 1500, 8, 1, 64), 1500, False),
            ((1, 127, 8, 1, 64), 1500, False)]
    dec = [((8, 8, 2, 128), 3073, _ragged_pos(torch, gen, 8, 1025, 3072)),
           ((8, 8, 1, 64), 448, _ragged_pos(torch, gen, 8, 1, 447)),
           ((8, 8, 1, 64), 1500, torch.full((8,), 1499, dtype=torch.int32,
                                            device="cuda"))]
    for dname, dt in dtypes.items():
        for (B, S, G, qpg, hd), sk, causal in attn:
            q = (EXTRA_Q_SCALE * torch.randn(B, S, G, qpg, hd, generator=gen,
                                             device="cuda")).to(dt)
            k = torch.randn(B, sk, G, hd, generator=gen, device="cuda").to(dt)
            v = torch.randn(B, sk, G, hd, generator=gen, device="cuda").to(dt)
            got = ops.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            close("flash_attention", got, ref.flash_attention_ref(
                q, k, v, causal=causal), dname,
                f"B={B} S={S} Sk={sk} Hq={G * qpg} Hkv={G} hd={hd} "
                f"causal={causal}")
        for (B, G, qpg, hd), S, pos in dec:
            q = (EXTRA_Q_SCALE * torch.randn(B, G, qpg, hd, generator=gen,
                                             device="cuda")).to(dt)
            k = torch.randn(B, S, G, hd, generator=gen, device="cuda").to(dt)
            v = torch.randn(B, S, G, hd, generator=gen, device="cuda").to(dt)
            got = ops.flash_decode(q, k, v, pos)
            torch.cuda.synchronize()
            close("flash_decode", got, ref.flash_decode_ref(q, k, v, pos),
                  dname, f"B={B} Hq={G * qpg} Hkv={G} hd={hd} S={S} "
                  f"pos={pos.tolist()}")
    return errs


def phase_extras_drain(torch, ops, cfg, model, params, workload, extras,
                       max_seq):
    """The main path, counted: one ReplicaEngine (``MAX_BATCH`` slots, bf16
    pool, the kernels) serving the workload's requests with their extras
    until every one finishes. Each decode step's host time (its
    ``finish_step``) and the device time of that same step's graph replay
    (CUDA events around the replay) are kept. Returns the engine, the
    launches, tok/s and the steps with every slot busy: host and device ms
    (medians) and their idle share (1 - device sum / host sum)."""
    from repro_torch.serving.engine import ReplicaEngine, Request

    eng = ReplicaEngine(model, params, max_batch=MAX_BATCH, max_seq=max_seq,
                        cache_dtype=torch.bfloat16, device="cuda")
    replays = []
    run = eng.graphs.run

    def timed_run(key, fn):
        n = eng.graphs.replays
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        out = run(key, fn)
        end.record()
        replays.append((start, end) if eng.graphs.replays > n else None)
        return out

    eng.graphs.run = timed_run
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    reqs = []
    for w, ex in zip(workload, extras):
        reqs.append(Request(w["rid"], w["prompt"],
                            max_new_tokens=w["max_new_tokens"]))
        reqs[-1].extras = ex
        eng.submit(reqs[-1])
    finished, steps = [], []
    while len(finished) < len(reqs):
        finished += eng.begin_step()
        busy = eng.n_decoding
        n = len(replays)
        t1 = time.perf_counter()
        finished += eng.finish_step()
        host_ms = (time.perf_counter() - t1) * 1e3
        if len(replays) > n:
            steps.append((busy, host_ms, replays[-1]))
        if eng.clock > 10_000:
            raise AssertionError(f"{cfg.name}: the drain did not end")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng.graphs.run = run
    launches = dict(ops.LAUNCHES)
    toks = sum(len(r.output) for r in reqs)
    shapes = len(eng._shapes)
    log(f"[extras] {cfg.name} drain, one replica of {MAX_BATCH} slots, "
        f"max_seq {max_seq} (a pool of {next(iter(eng.cache.values())).shape[2]}"
        f" positions), bf16: launches {launches}; {eng.prefill_dispatches} "
        f"single admits, {eng.steps} decode steps, {shapes} prefill shapes; "
        f"syncs {eng.syncs}, sync wait {eng.sync_wait:.3f}s; {len(finished)} "
        f"requests, {toks} tokens in {wall:.2f}s: {toks / wall:.1f} tok/s")
    if len(finished) != len(reqs) or not all(r.done and r.output
                                             for r in reqs):
        raise AssertionError(f"{cfg.name}: {len(finished)}/{len(reqs)} "
                             "finished, or an empty stream")
    _check_launches(cfg, launches, eng.prefill_dispatches, eng.steps)
    full = [(ms, ev[0].elapsed_time(ev[1])) for busy, ms, ev in steps
            if busy == MAX_BATCH and ev is not None]
    if not full:
        raise AssertionError(f"{cfg.name}: no replayed step had every slot "
                             "busy")
    host, dev = zip(*full)
    step = dict(n=len(full), host_ms=statistics.median(host),
                device_ms=statistics.median(dev),
                idle=1 - sum(dev) / sum(host))
    return eng, launches, toks / wall, step


def _greedy(torch, model, params, req, extras, backend, n_new):
    """One request alone, greedy, through one backend: the stream and the
    logits of the prefill and of every decode step."""
    batch = {"tokens": torch.tensor([req["prompt"]], dtype=torch.int32,
                                    device="cuda")}
    for k, v in extras.items():
        batch[k] = torch.from_numpy(v).cuda()
    logits, state, pos = model.prefill(params, batch,
                                       cache_len=len(req["prompt"]) + n_new,
                                       cache_dtype=torch.float32,
                                       attn_backend=backend)
    out = [logits.float()]
    for _ in range(n_new - 1):
        tok = torch.argmax(out[-1], dim=-1)[:, None].to(torch.int32)
        logits, state = model.decode(params, state, tok, pos,
                                     attn_backend=backend)
        pos = pos + 1
        out.append(logits.float())
    return out


def phase_extras_paths(torch, cfg, workload, extras) -> None:
    """The first ``EXTRA_PATHS`` requests in f32 at full width and depth,
    each alone and greedy through the kernel path and the einsum path:
    the largest |logit difference| / max|logits| at prefill and at the
    first decode step (held to F32_PATH_TOL: the paths differ by the order
    of f32 sums), and the streams' differences -- where a stream first
    diverges, the einsum path's top-2 logit margin there."""
    from repro_torch.models.model import make_model

    model = make_model(cfg)
    params = model.init(seed=SEED, dtype=torch.float32, device="cuda")
    gap = {0: 0.0, 1: 0.0}
    report = []
    for w, ex in list(zip(workload, extras))[:EXTRA_PATHS]:
        n_new = w["max_new_tokens"]
        run = {b: _greedy(torch, model, params, w, ex, b, n_new)
               for b in ("pallas", "einsum")}
        for i in (0, 1):
            e = run["einsum"][i]
            gap[i] = max(gap[i], ((run["pallas"][i] - e).abs().max()
                                  / e.abs().max()).item())
        ks = [int(t.argmax()) for t in run["pallas"]]
        es = [int(t.argmax()) for t in run["einsum"]]
        first = next((j for j, (a, b) in enumerate(zip(ks, es)) if a != b),
                     None)
        if first is None:
            report.append(f"rid {w['rid']}: {n_new} tokens equal")
        else:
            top2 = run["einsum"][first][0].topk(2).values
            report.append(f"rid {w['rid']}: first differs at token {first} "
                          f"of {n_new}, einsum top-2 margin "
                          f"{(top2[0] - top2[1]).item():.3e}")
    del params
    _free(torch)
    log(f"[paths] {cfg.name} f32 full width, {cfg.num_layers} layers, "
        f"{EXTRA_PATHS} requests alone: max|kernel-einsum| / max|einsum| at "
        f"prefill {gap[0]:.3e}, at the first decode step {gap[1]:.3e} "
        f"(tolerance {F32_PATH_TOL}); greedy streams: {'; '.join(report)}")
    if not max(gap.values()) <= F32_PATH_TOL:
        raise AssertionError(f"{cfg.name}: f32 paths differ by "
                             f"{max(gap.values()):.3e}")


def phase_extras_times(torch, F, ops, ref, cfg, model, params, eng, workload,
                       extras, max_seq, step, smi) -> dict:
    """One admit's prefill (the longest prompt with its extras) on the host
    clock, from staging its tokens and extras as the engine does to its
    first token, and on the device (CUDA-graph replay); the drain's decode
    steps with every slot busy (``step``, from ``phase_extras_drain``);
    then the attention kernels at this model's shapes against plain, SDPA
    and the bound. Returns the kernel rows."""
    import numpy as np

    from repro_torch.serving.engine import _stage, stage_extras

    P = cfg.num_patches
    longest = max(range(len(workload)),
                  key=lambda i: len(workload[i]["prompt"]))
    prompt = workload[longest]["prompt"]
    dev = torch.device("cuda")

    def stage():
        batch = {"tokens": _stage(dev, np.asarray([prompt]))[0]}
        batch.update(stage_extras(extras[longest], dev, torch.bfloat16))
        return batch

    def prefill(batch):
        return model.prefill(params, batch, cache_len=len(prompt),
                             cache_dtype=torch.bfloat16)

    torch.argmax(prefill(stage())[0], dim=-1).cpu()
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        torch.argmax(prefill(stage())[0], dim=-1).cpu()
        host.append((time.perf_counter() - t0) * 1e3)
    staged = stage()
    prefill_dev = _graph_ms(torch, lambda: prefill(staged), 1, reps=3)
    depth = [min(P + len(w["prompt"]) + MAX_NEW // 2, max_seq - 2)
             for w in workload[:MAX_BATCH]]
    pos = torch.tensor(depth, dtype=torch.int32, device="cuda")
    log(f"[extras] {cfg.name} bf16, {smi}: single-admit prefill of "
        f"{(P or 0) + len(prompt)} positions ({len(prompt)} tokens"
        f"{f' after {P} patches' if P else ''}"
        f"{f', {cfg.encoder_seq_len} frames encoded' if cfg.encoder_seq_len else ''}"
        f"): host {statistics.median(host):.2f} ms (median of 3, from "
        f"staging the tokens and extras to its first token), device "
        f"{prefill_dev:.2f} ms (CUDA-graph replay, median of 3); decode "
        f"step, {MAX_BATCH} slots, the drain's {step['n']} replayed steps "
        f"with every slot busy: host {step['host_ms']:.2f} ms (finish_step, "
        f"median), device {step['device_ms']:.2f} ms (CUDA events around "
        f"the same steps' graph replays, median): idle share "
        f"{step['idle']:.3f} (1 - device sum / host sum)")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    G, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    qpg = cfg.num_heads // G
    bf = torch.bfloat16
    q = torch.randn(MAX_BATCH, G, qpg, hd, generator=gen, device="cuda").to(bf)
    L = cfg.num_layers
    if cfg.family == "vlm":
        c = eng.cache
        return {"flash_attention": {"prefill": _time_attention(
            torch, F, ops, ref, gen, 1, P + len(prompt), G, qpg, hd,
            f"{cfg.name} prefill, patches + longest prompt")},
            "flash_decode": {"decode": _time_decode(
                torch, F, ops, ref, q, [(c["k"][li], c["v"][li])
                                        for li in range(L)], pos,
                f"{cfg.name} drain pool")}}
    c = eng.cache
    Le = cfg.encoder_seq_len
    cross = torch.full((MAX_BATCH,), Le - 1, dtype=torch.int32,
                       device="cuda")
    return {"flash_attention": {
        "encoder": _time_attention(torch, F, ops, ref, gen, 1, Le, G, qpg,
                                   hd, f"{cfg.name} encoder", causal=False),
        "cross": _time_attention(torch, F, ops, ref, gen, 1, len(prompt), G,
                                 qpg, hd, f"{cfg.name} decoder cross, the "
                                 "longest prompt", causal=False, sk=Le),
        "self": _time_attention(torch, F, ops, ref, gen, 1, len(prompt), G,
                                qpg, hd, f"{cfg.name} decoder self, the "
                                "longest prompt")},
        "flash_decode": {
            "cross": _time_decode(torch, F, ops, ref, q, [
                (c["cross_k"][li], c["cross_v"][li]) for li in range(L)],
                cross, f"{cfg.name} cross cache"),
            "self": _time_decode(torch, F, ops, ref, q, [
                (c["self_k"][li], c["self_v"][li]) for li in range(L)],
                pos, f"{cfg.name} self cache")}}


def serve_extras(torch, F, ops, ref, cfg, smi) -> dict:
    """Phase 12 for one architecture at full width and depth, bf16 weights
    from ``SEED``: the counted drain of requests with extras, the kernels'
    times at its shapes, then the f32 kernel-vs-einsum comparison. Returns
    the launches and kernel rows."""
    from repro_torch.data.pipeline import prompt_workload
    from repro_torch.models.model import make_model

    run = EXTRA_ARCHS[cfg.name]
    t0 = time.perf_counter()
    model = make_model(cfg)
    params = model.init(seed=SEED, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    log(f"[model] {cfg.name}: {_describe(cfg)}"
        + (f", {cfg.num_patches} patches" if cfg.num_patches else "")
        + (f", encoder {cfg.encoder_layers} layers over "
           f"{cfg.encoder_seq_len} frames" if cfg.encoder_layers else "")
        + f"; {cfg.param_count() / 1e9:.3f} B params, "
        f"{_param_bytes(params) / 1e9:.2f} GB in bf16, random from seed "
        f"{SEED}, built in {time.perf_counter() - t0:.1f}s; nothing cut "
        f"(widths and depth are the published config's)")
    workload = prompt_workload(cfg.vocab_size, N_REQUESTS, seed=SEED,
                               max_len=run["max_prompt"], max_new=MAX_NEW)
    extras = _extras(cfg, N_REQUESTS, SEED + 12)
    if cfg.family == "vlm":
        need = cfg.num_patches + max(len(w["prompt"]) + w["max_new_tokens"]
                                     for w in workload)
        log(f"[extras] {cfg.name}: max_seq {run['max_seq']} because the "
            f"reference's retirement (pos >= max_seq - 1) counts the "
            f"{cfg.num_patches}-patch prefix: the longest request needs "
            f"{need} positions, so no request is cut short")
    eng, launches, tok_s, step = phase_extras_drain(
        torch, ops, cfg, model, params, workload, extras, run["max_seq"])
    rows = phase_extras_times(torch, F, ops, ref, cfg, model, params, eng,
                              workload, extras, run["max_seq"], step, smi)
    del eng
    _free(torch)
    fleet = phase_fleet_extras(torch, ops, cfg, model, params, workload,
                               extras, run["max_seq"], step, smi)
    del params
    _free(torch)
    phase_extras_paths(torch, cfg, workload, extras)
    return {"launches": launches, "rows": rows, "tok_s": tok_s,
            "fleet": fleet}


def phase_families(torch, F, ops, ref, smi, errs) -> dict:
    """Phase 12: the two architectures' runs; adds the new shapes' parity
    errors to ``errs``. Returns each run's launches and kernel rows."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    for name, err in phase_parity_extras(torch, ops, ref, gen).items():
        errs[name] = max(errs[name], err)
    out = {}
    for name in EXTRA_ARCHS:
        out[name] = serve_extras(torch, F, ops, ref, get_config(name), smi)
        _free(torch)
    log(f"[extras] phase 12: {time.perf_counter() - t0:.1f}s")
    return out


def extras_rows(rows: dict, runs: dict) -> None:
    """The two architectures' entries in the kernels line: ``vlm`` and
    ``audio`` under each attention kernel, with the launches of their
    drain runs and the times at each of their shapes (the first shape's
    numbers at the entry's top level)."""
    from repro_torch.configs import get_config

    for name, run in runs.items():
        cfg = get_config(name)
        for kernel in ("flash_attention", "flash_decode"):
            shapes = run["rows"][kernel]
            first = next(iter(shapes.values()))
            rows[kernel][cfg.family] = dict(
                arch=name, launches=run["launches"][kernel],
                launches_of=f"{name}'s drain of {N_REQUESTS} requests with "
                            "extras, one replica",
                **first, shapes=shapes)


# --------------------------------------------------------------- phase 14
# fleets of vlm and audio replicas, and fleet-mesh serving. (a) runs inside
# phase 12's model lifetime (``serve_extras``), (b) and (c) inside
# granite-3-8b's (``serve_arch``)
FLEET_NODES = 2        # (a): the elastic frontend's nodes, one replica each
MESH_SHARDS = 2        # (b): shards of the fleet mesh, both on cuda:0
SEQ_KV = dict(B=2, G=8, qpg=4, hd=128, S=4096)   # (c): granite's heads
SEQ_KV_POS = (0, 100, 2047, 4095)


def _sync_checked(torch, fn):
    """``fn()`` under torch's sync debug mode: (its result, the count of
    synchronising operations by ``file:line``)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, collections.Counter(
        f"{_where(w.filename)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))


def _elastic_fleet(torch, model, params, workload, extras, max_seq, dtype,
                   fleet_batch=True):
    """The workload's requests with their extras through an elastic
    frontend of ``FLEET_NODES`` nodes, one replica each (fleet batching and
    the async tick, its defaults), ticked until drained: (frontend, the
    per-tick metrics)."""
    from repro_torch.serving.elastic import ElasticClusterFrontend
    from repro_torch.serving.engine import ReplicaEngine, Request

    def make(rid):
        return ReplicaEngine(model, params, max_batch=MAX_BATCH,
                             max_seq=max_seq, rid=rid, cache_dtype=dtype,
                             device="cuda")

    fe = ElasticClusterFrontend(make, FLEET_NODES, initial_replicas=1,
                                seed=SEED, fleet_batch=fleet_batch)
    for w, ex in zip(workload, extras):
        req = Request(w["rid"], w["prompt"],
                      max_new_tokens=w["max_new_tokens"])
        req.extras = ex
        fe.submit(req)
    ticks = []
    while fe.pending or any(n.unfinished() for n in fe.nodes):
        ticks.append(fe.tick(0.0))
        if len(ticks) > 10_000:
            raise AssertionError("the fleet did not drain")
    return fe, ticks


def phase_fleet_extras(torch, ops, cfg, model, params, workload, extras,
                       max_seq, step, smi) -> dict:
    """Phase 14(a): phase 12's requests with their extras through a fleet
    of ``cfg``'s replicas (bf16, full width and depth) under the elastic
    frontend, counted: flash_attention per exact-length admit and
    flash_decode per fleet decode dispatch as ``_per_dispatch`` says,
    every request finished, the ledger balanced, the async tick's sync
    contract kept and no host sync in the engine but the admits' own; the
    fleet decode dispatch's host / device ms and idle share beside phase
    12's standalone step. Then at 2 layers in f32 the fleet's streams
    against ``fleet_batch=False``'s."""
    from repro_torch.models.model import make_model
    from repro_torch.serving.elastic import async_tick_violations

    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    (fe, ticks), flagged = _sync_checked(torch, lambda: _elastic_fleet(
        torch, model, params, workload, extras, max_seq, torch.bfloat16))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    admits = _admit_fetch_lines()
    hidden = {k: n for k, n in flagged.items()
              if k.startswith("src/repro_torch/") and k not in admits}
    if hidden:
        raise AssertionError(f"{cfg.name} fleet: host syncs besides the "
                             f"exact-length admits': {hidden}")
    prefill, decode = fe.shard_dispatches()
    _check_launches(cfg, launches, prefill, decode)
    led = fe.ledger
    if not (led.balanced() and len(fe.finished) == len(workload)
            and all(r.done and r.output for r in fe.finished)):
        raise AssertionError(f"{cfg.name} fleet: ledger {led.balance()}, "
                             f"{len(fe.finished)}/{len(workload)} finished")
    broken = async_tick_violations(ticks)
    if broken:
        raise AssertionError(f"{cfg.name} fleet: async tick sync contract: "
                             f"{broken}")
    toks = sum(len(r.output) for r in fe.finished)
    log(f"[fleet] {cfg.name} bf16, {FLEET_NODES} nodes x 1 replica of "
        f"{MAX_BATCH} slots, one fleet group: launches {launches}; fleet "
        f"decode dispatches {fe.decode_dispatches()}, admissions {prefill} "
        f"(exact-length singles), syncs {fe.sync_count()} (the admits' own "
        f"{sum(t['replica_syncs'] for t in ticks)}), flagged "
        f"{dict(flagged)}; {len(fe.finished)} requests, {toks} tokens in "
        f"{wall:.2f}s: {toks / wall:.1f} tok/s; {len(ticks)} ticks, async "
        f"contract kept")
    rep = _graph_report(torch, cfg, fe)
    log(f"[fleet] {cfg.name} bf16, {smi}: fleet decode dispatch "
        f"({rep['rows']} slab rows) host {rep['host_ms']:.2f} ms, device "
        f"{rep['device_ms']:.2f} ms, idle share {rep['idle']:.3f}; phase "
        f"12's standalone step ({MAX_BATCH} slots): host "
        f"{step['host_ms']:.2f} ms, device {step['device_ms']:.2f} ms, idle "
        f"share {step['idle']:.3f}")
    del fe
    _free(torch)

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    model2 = make_model(cfg2)
    params2 = model2.init(seed=SEED, dtype=torch.float32, device="cuda")
    digests = {}
    for fb in (True, False):
        fe2, _ = _elastic_fleet(torch, model2, params2, workload, extras,
                                max_seq, torch.float32, fleet_batch=fb)
        digests[fb] = (_digest(fe2), fe2.decode_dispatches())
        del fe2
    del params2
    _free(torch)
    same = digests[True][0] == digests[False][0]
    log(f"[fleet] {cfg.name} f32 full width, 2 layers: the fleet's "
        f"{len(digests[True][0])} streams and clocks equal "
        f"fleet_batch=False's: {same} (fleet decode dispatches "
        f"{digests[True][1]} against {digests[False][1]})")
    if not same or digests[True][1] == 0:
        raise AssertionError(f"{cfg.name}: the f32 fleet differs from "
                             "per-replica decode")
    return {"launches": launches, "decode": decode, "prefill": prefill,
            "tok_s": toks / wall, "dispatch": rep, "step": step}


def _two_shards():
    """An explicit fleet mesh of ``MESH_SHARDS`` shards, all on cuda:0 (the
    one card: a mesh repeats a device only when given the list)."""
    from repro_torch.launch.mesh import make_mesh

    return make_mesh((MESH_SHARDS,), ("fleet",),
                     devices=["cuda:0"] * MESH_SHARDS)


def phase_mesh(torch, ops, ref, cfg, model, params, control, small,
               oracle) -> dict:
    """Phase 14(b) and (c). The control loop of phase 6 over an explicit
    2-shard fleet mesh on cuda:0, counted and sync-checked as phase 6:
    its dispatch and sync counts (per tick too) equal the unsharded
    run's, every slab's capacity divides over the shards, and the launches
    follow from the shards' own runs (a masked sub-step round runs only
    on the shards holding a stepping row); bf16 streams that differ from
    the unsharded run's are counted (cuBLAS's bf16 products are not
    batch-invariant). At 2 layers in f32 the digest equals the unsharded
    loop's (phase 8's). The CLI with ``--devices 1`` on the card; with
    ``--devices 2`` on a one-card machine it raises. Then (c)."""
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    mesh = _two_shards()
    sharded = phase_control(torch, ops, cfg, model, params, mesh=mesh)
    diff = {k: (sharded[k], control[k]) for k in
            ("per_tick", "decode", "prefill", "syncs")
            if sharded[k] != control[k]}
    runs = sharded["shard_runs"]
    ratio = {k: sharded["launches"][k] / control["launches"][k]
             for k in ("flash_decode", "flash_attention")}
    log(f"[mesh] {cfg.name} bf16 over {MESH_SHARDS} shards on cuda:0: "
        f"decode dispatches {sharded['decode']}, admissions "
        f"{sharded['prefill']}, syncs {sharded['syncs']} (unsharded "
        f"{control['decode']}, {control['prefill']}, {control['syncs']}); "
        f"the shards' runs: admissions {runs[0]}, decode steps {runs[1]}; "
        f"launches {sharded['launches']} = {ratio['flash_decode']:.3f}x "
        f"(flash_decode) and {ratio['flash_attention']:.3f}x "
        f"(flash_attention) the unsharded run's; live slab caps "
        f"{sharded['caps']}; streams differing from the unsharded run's "
        f"{_differing(sharded['digest'], control['digest'])}/"
        f"{len(control['digest'])} (bf16); {sharded['tok_s']:.1f} tok/s "
        f"against {control['tok_s']:.1f}")
    if diff:
        raise AssertionError(f"sharded counts differ: {diff}")
    if any(c % MESH_SHARDS for c in sharded["caps"]) or \
            sharded["rows"] % MESH_SHARDS:
        raise AssertionError(f"slab caps {sharded['caps']} do not divide")
    if not runs[1] > sharded["decode"]:
        raise AssertionError("no decode ran on both shards")

    cfg2, model2, params2 = small
    out = serve.run_control_loop(_control_args(serve), cfg2, model2,
                                 params2, cache_dtype=torch.float32,
                                 mesh=mesh)
    f32_digest = _digest(out["fe"])
    same = f32_digest == oracle
    log(f"[mesh] f32 full width, 2 layers, {MESH_SHARDS} shards: digest "
        f"equal to the unsharded loop's: {same}")
    if not same:
        raise AssertionError("the sharded f32 control loop differs")
    del out
    _free(torch)

    cli = ["--policy", "ours", "--autoscale", "gpso", "--ticks", "10",
           "--device", "cuda"]
    res = serve.main(cli + ["--devices", "1"])
    shards = {g.shards for g in res["fe"]._fleets.values()}
    if not (res["fe"].ledger.balanced() and shards == {1}):
        raise AssertionError(f"--devices 1: shards {shards}, ledger "
                             f"{res['fe'].ledger.balance()}")
    del res
    if torch.cuda.device_count() < 2:
        try:
            serve.main(cli + ["--devices", "2"])
        except RuntimeError as e:
            log(f"[mesh] --devices 2 on {torch.cuda.device_count()} card: "
                f"raises {e}")
        else:
            raise AssertionError("--devices 2 ran on one card")
    err = phase_seq_kv(torch, ref)
    log(f"[mesh] phase 14(b, c): {time.perf_counter() - t0:.1f}s")
    return {"launches": sharded["launches"], "shard_runs": runs,
            "decode": sharded["decode"], "prefill": sharded["prefill"],
            "ratio": ratio, "seq_kv_err": err,
            "unsharded": control["launches"],
            "peak_bytes": sharded["peak_bytes"], "digest": sharded["digest"],
            "per_tick": sharded["per_tick"], "syncs": sharded["syncs"],
            "tok_s": sharded["tok_s"], "f32_digest": f32_digest}


def phase_seq_kv(torch, ref) -> float:
    """Phase 14(c): ``seq_sharded_flash_decode`` on a (data 1, model 2)
    mesh over cuda:0 at granite's heads (32 q / 8 kv, hd 128), S 4,096,
    at each of ``SEQ_KV_POS``, in f32 against flash_decode's plain
    version (2e-5)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.seq_kv import (seq_kv_cache_bytes,
                                                seq_sharded_flash_decode)
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, 2), ("data", "model"), devices=["cuda:0"] * 2)
    B, G, qpg, hd, S = (SEQ_KV[k] for k in ("B", "G", "qpg", "hd", "S"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    worst = 0.0
    for pos in SEQ_KV_POS:
        q, k, v = (torch.randn(*shape, generator=gen, device="cuda")
                   for shape in ((B, G, qpg, hd), (B, S, G, hd),
                                 (B, S, G, hd)))
        got = seq_sharded_flash_decode(mesh, q.reshape(B, G * qpg, hd), k,
                                       v, pos)
        want = ref.flash_decode_ref(q, k, v, torch.full(
            (B,), pos, dtype=torch.int32, device="cuda"))
        worst = max(worst, _close("seq_sharded_flash_decode", got,
                                  want.reshape(B, G * qpg, hd), "float32",
                                  torch))
    log(f"[mesh] seq_sharded_flash_decode, (data 1, model 2) over cuda:0, "
        f"B {B}, {G * qpg} q / {G} kv heads, hd {hd}, S {S}, pos "
        f"{list(SEQ_KV_POS)}: max|err| {worst:.3e} against flash_decode's "
        f"plain version (f32, atol/rtol {TOLS['float32']['atol']}); "
        f"granite-3-8b's cache at B 1, S {S}: "
        f"{seq_kv_cache_bytes(get_config('granite-3-8b'), 1, S) / 2**20:.0f}"
        f" MiB")
    return worst


def fleet_rows(rows: dict, families: dict, mesh: dict) -> None:
    """Phase 14's entries in the kernels line: under each attention kernel,
    ``fleet`` (the vlm and audio fleets' launches) and ``mesh`` (the
    sharded control loop's, beside the unsharded run's, and under
    ``replicated_axis`` phase 14(e)'s)."""
    for kernel in ("flash_attention", "flash_decode"):
        rows[kernel]["fleet"] = {
            name: dict(launches=run["fleet"]["launches"][kernel],
                       launches_of=f"{name}'s elastic fleet of "
                                   f"{FLEET_NODES} replicas, {N_REQUESTS} "
                                   "requests with extras")
            for name, run in families.items()}
        seq = mesh["replicated_axis"]["launches"]
        rows[kernel]["mesh"] = dict(
            launches=mesh["launches"][kernel],
            unsharded_launches=mesh["unsharded"][kernel],
            launches_of=f"granite-3-8b's control loop over {MESH_SHARDS} "
                        "shards on cuda:0",
            replicated_axis=dict(
                launches=seq[kernel],
                launches_of="granite-3-8b's control loop over (fleet 2, "
                            "seq 2) on cuda:0 (phase 14(e))"))



# ------------------------------------------------------------ phase 14(d)
# fleet meshes over the 'model' and data-like axes, every device cuda:0
# (one card: the split's machinery, not a second card). granite-3-8b's
# 8 kv heads go 4 a model device, mamba2-1.3b's 64 SSM heads 32 and
# zamba2-2.7b's 80 heads (its shared block's 32 kv heads) 40 (16)
MODEL_AXIS_MESH = ((2, 2), ("fleet", "model"))
DATA_AXIS_MESH = ((2, 2), ("fleet", "data"))
SSM_AXIS_MESH = ((1, 2), ("fleet", "model"))
# the split kernels' shapes: the control loop's 32-row slab of
# CONTROL_MAX_SEQ at granite's heads halved (4 kv x qpg 4, hd 128), its
# largest fleet prefill there, and the ssm archs' heads halved at the
# control loop's fleet prefill (8 x 16) and a drain-mode bucket (2 x 96)
SPLIT_ROWS = 32
SPLIT_SSD_CASES = ((8, 16), (2, 96))


def _card_mesh(shape, axes):
    """A mesh of ``shape`` whose every device is cuda:0."""
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, axes, devices=["cuda:0"] * math.prod(shape))


def phase_split_kernels(torch, F, ops, ref, cfg, control) -> dict:
    """Phase 14(d)'s kernels at the shapes a model device runs: each
    against its plain version on the card (f32 2e-5, bf16 3e-2; ssd_scan
    f32 1e-4), then timed as phase 7 times them. flash_decode over
    ``SPLIT_ROWS`` rows of ``CONTROL_MAX_SEQ`` at granite's kv heads over
    2 (ragged depths as the loop's), flash_attention at the loop's
    largest fleet prefill there, ssd_scan at both ssm archs' heads over
    2. Returns each kernel's max |err| and times."""
    from repro_torch.configs import get_config

    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    G = cfg.num_kv_heads // 2
    qpg, hd = cfg.num_heads // cfg.num_kv_heads, cfg.resolved_head_dim
    out = {}
    pos = _ragged_pos(torch, gen, SPLIT_ROWS, *CONTROL_DEPTH)
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn(SPLIT_ROWS, G, qpg, hd, generator=gen,
                        device="cuda").to(dt)
        k, v = (torch.randn(SPLIT_ROWS, CONTROL_MAX_SEQ, G, hd, generator=gen,
                            device="cuda").to(dt) for _ in range(2))
        worst = max(worst, _close("flash_decode (split)",
                                  ops.flash_decode(q, k, v, pos),
                                  ref.flash_decode_ref(q, k, v, pos),
                                  str(dt).split(".")[1], torch))
    views = [tuple(torch.randn(SPLIT_ROWS, CONTROL_MAX_SEQ, G, hd,
                               generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(2))
             for _ in range(cfg.num_layers)]
    t = _time_decode(torch, F, ops, ref, q, views, pos,
                     f"split (a model device's {G} of {cfg.num_kv_heads} "
                     f"kv heads, {CARD})")
    out["flash_decode"] = dict(max_abs_err=worst, timed_at=(
        f"{SPLIT_ROWS} slab rows x {CONTROL_MAX_SEQ}, {G} kv heads x qpg "
        f"{qpg}, hd {hd}, bf16"), **t)
    del views
    kb, sb = _largest(control["shapes"], "afleet_prefill")
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn(kb, sb, G, qpg, hd, generator=gen,
                        device="cuda").to(dt)
        k, v = (torch.randn(kb, sb, G, hd, generator=gen,
                            device="cuda").to(dt) for _ in range(2))
        worst = max(worst, _close(
            "flash_attention (split)", ops.flash_attention(q, k, v,
                                                           causal=True),
            ref.flash_attention_ref(q, k, v, causal=True),
            str(dt).split(".")[1], torch))
    t = _time_attention(torch, F, ops, ref, gen, kb, sb, G, qpg, hd,
                        f"split (fleet prefill, a model device's heads, "
                        f"{CARD})")
    out["flash_attention"] = dict(max_abs_err=worst, timed_at=(
        f"fleet prefill K {kb} x bucket {sb}, {G} kv heads x qpg {qpg}, "
        f"hd {hd}, causal, bf16"), **t)
    worst, times = 0.0, {}
    for name in SSM_ARCHS:
        c = get_config(name)
        H, P, N = c.ssm_heads // 2, c.ssm_head_dim, c.ssm_state
        for B, T in SPLIT_SSD_CASES:
            x, a, bm, cm = _ssd_inputs(torch, gen, B, T, H, P, N)
            chunk = min(c.ssm_chunk, T)
            y, st = ops.ssd_scan(x, a, bm, cm, chunk=chunk)
            y_ref, st_ref = ref.ssd_scan_ref(x, a, bm, cm, chunk)
            for got, want in ((y, y_ref), (st, st_ref)):
                torch.testing.assert_close(got, want, **SSD_TOL, msg=lambda
                                           m: f"ssd_scan {name} H {H}: {m}")
            worst = max(worst, (y - y_ref).abs().max().item(),
                        (st - st_ref).abs().max().item())
        half = types.SimpleNamespace(
            name=f"{name} (split, {H} of {c.ssm_heads} heads, {CARD})",
            ssm_heads=H, ssm_head_dim=P, ssm_state=N, ssm_chunk=c.ssm_chunk)
        times[name] = _time_ssd(torch, ops, ref, gen, half,
                                *SPLIT_SSD_CASES[0], "control loop prefill")
    log(f"[mesh] ssd_scan at {[get_config(n).ssm_heads // 2 for n in SSM_ARCHS]}"
        f" heads, cases {list(SPLIT_SSD_CASES)}: max|err| {worst:.3e} "
        f"(atol/rtol {SSD_TOL['atol']})")
    out["ssd_scan"] = dict(max_abs_err=worst, timed_at=(
        f"{SSM_ARCHS[0]}'s {get_config(SSM_ARCHS[0]).ssm_heads // 2} heads,"
        f" fleet prefill {SPLIT_SSD_CASES[0][0]} x {SPLIT_SSD_CASES[0][1]}"),
        **times[SSM_ARCHS[0]])
    out["ssd_scan"]["zamba2"] = times[SSM_ARCHS[1]]
    return out


def phase_model_axis(torch, F, ops, ref, cfg, model, params, control, small,
                     oracle, fleet_only) -> dict:
    """Phase 14(d) for granite-3-8b. Phase 6's control loop at full width
    and depth, bf16, over (fleet 2, model 2) on cuda:0, counted and
    sync-checked as phase 6: every kernel of a dispatch once a model
    device (a layer's flash_decode twice a shard step), its decode,
    admission and sync counts, per tick too, equal to the unsharded run's,
    its decode steps captured as CUDA graphs (every device of a row block
    is cuda:0), each model device's peak slab bytes half those of phase
    14(b)'s (fleet 2) run; bf16 streams that differ and tok/s reported,
    and one decode dispatch's host and device ms over the split slab
    beside the whole one. At 2 layers in f32 the digests over (fleet 2,
    model 2) and (fleet 2, data 2) equal the unsharded loop's (phase 8's).
    Then the kernels at the split shapes (``phase_split_kernels``)."""
    from repro_torch.distributed.sharding import HeadLayout
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    mesh = _card_mesh(*MODEL_AXIS_MESH)
    run = phase_control(torch, ops, cfg, model, params, mesh=mesh)
    diff = {k: (run[k], control[k]) for k in
            ("per_tick", "decode", "prefill", "syncs")
            if run[k] != control[k]}
    halves = {}
    for key, blocks in run["peak_bytes"].items():
        whole = fleet_only["peak_bytes"][key]
        halves[key] = [(per, w[0]) for per, w in zip(blocks, whole)]
    runs = run["shard_runs"]
    L = cfg.num_layers
    log(f"[mesh] {cfg.name} bf16 over (fleet 2, model 2) on cuda:0 "
        f"({CARD}): decode dispatches {run['decode']}, admissions "
        f"{run['prefill']}, syncs {run['syncs']} (unsharded "
        f"{control['decode']}, {control['prefill']}, {control['syncs']}); "
        f"the shards' runs: admissions {runs[0]}, decode steps {runs[1]}; "
        f"launches {run['launches']} (flash_decode {L} x 2 model devices a "
        f"shard step: {run['launches']['flash_decode'] == 2 * L * runs[1]})"
        f"; streams differing from the unsharded run's "
        f"{_differing(run['digest'], control['digest'])}/"
        f"{len(control['digest'])}, from the (fleet 2) run's "
        f"{_differing(run['digest'], fleet_only['digest'])} (bf16); "
        f"{run['tok_s']:.1f} tok/s against {control['tok_s']:.1f} "
        f"unsharded")
    log(f"[mesh] peak slab bytes a device (group max_batch: per row block, "
        f"the model devices' bytes | the (fleet 2) run's row block): "
        + "; ".join(f"{key}: " + ", ".join(f"{per} | {w}" for per, w in hs)
                    for key, hs in sorted(halves.items())))
    log(f"[mesh] decode steps ran as "
        f"{'eager steps' if run['eager'] else 'CUDA graphs'}: "
        f"{run['graphs']}")
    if diff:
        raise AssertionError(f"(fleet 2, model 2) counts differ: {diff}")
    if run["eager"] or not run["graphs"].get("replays"):
        raise AssertionError("the split decode steps were not captured")
    if any(2 * b != w for hs in halves.values() for per, w in hs
           for b in per):
        raise AssertionError(f"the model axis does not halve the slab: "
                             f"{halves}")
    rows = max(run["rows"] // 2, 1)
    layout = HeadLayout(mesh, ["cuda:0"] * 2)
    host, dev = _fleet_step_times(torch, model, params, rows,
                                  CONTROL_MAX_SEQ, layout=layout)
    host1, dev1 = _fleet_step_times(torch, model, params, rows,
                                    CONTROL_MAX_SEQ)
    log(f"[mesh] a row block's decode dispatch, {rows} rows ({CARD}): "
        f"split over 2 model devices {host:.2f} ms host / {dev:.2f} ms "
        f"device; whole {host1:.2f} / {dev1:.2f}")

    cfg2, model2, params2 = small
    for label, spec in (("fleet 2, model 2", MODEL_AXIS_MESH),
                        ("fleet 2, data 2", DATA_AXIS_MESH)):
        out = serve.run_control_loop(_control_args(serve), cfg2, model2,
                                     params2, cache_dtype=torch.float32,
                                     mesh=_card_mesh(*spec))
        same = _digest(out["fe"]) == oracle
        log(f"[mesh] f32 full width, 2 layers, ({label}): digest equal to "
            f"the unsharded loop's: {same}")
        if not same:
            raise AssertionError(f"the ({label}) f32 control loop differs")
        del out
        _free(torch)
    kernels = phase_split_kernels(torch, F, ops, ref, cfg, control)
    log(f"[mesh] phase 14(d), granite-3-8b: "
        f"{time.perf_counter() - t0:.1f}s")
    return {"launches": run["launches"], "shard_runs": runs,
            "tok_s": run["tok_s"], "kernels": kernels,
            "step_ms": (host, dev, host1, dev1)}


def phase_model_axis_ssm(torch, ops, cfg, small, oracle) -> dict:
    """Phase 14(d) for an ssm arch: the control loop at full width cut to
    2 layers in f32 over (fleet 1, model 2) on cuda:0 -- each replica's
    SSM heads and conv channels (the hybrid's shared block's kv heads
    too) split over the model devices -- counted: its digest equals the
    unsharded loop's (phase 8's), and every kernel of a dispatch ran once
    a model device."""
    from repro_torch.launch import serve
    from repro_torch.models.layers import HeadBlocks

    t0 = time.perf_counter()
    cfg2, model2, params2 = small
    torch.cuda.synchronize()
    ops.reset_launches()
    out = serve.run_control_loop(_control_args(serve), cfg2, model2,
                                 params2, cache_dtype=torch.float32,
                                 mesh=_card_mesh(*SSM_AXIS_MESH))
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    fe = out["fe"]
    same = _digest(fe) == oracle
    runs = fe.shard_dispatches()
    split = all(isinstance(leaf, HeadBlocks) and not leaf.whole
                for g in fe._fleets.values() for p in g.parts
                for leaf in p.slab.values())
    log(f"[mesh] {cfg.name} f32 full width, 2 layers, (fleet 1, model 2) "
        f"on cuda:0: digest equal to the unsharded loop's: {same}; every "
        f"leaf split: {split}; launches {launches} over the shards' "
        f"admissions {runs[0]} and decode steps {runs[1]}; "
        f"{time.perf_counter() - t0:.1f}s")
    _check_launches(cfg2, launches, *runs, len(out["ticks"]), heads=2)
    if not (same and split):
        raise AssertionError(f"{cfg.name} over (fleet 1, model 2): digest "
                             f"equal {same}, split {split}")
    del out
    _free(torch)
    return {"launches": launches, "shard_runs": runs}


def model_axis_rows(rows: dict, served: dict) -> None:
    """Phase 14(d)'s entries in the kernels line: under each serving
    kernel, ``model_axis`` -- its launches on the split path (granite's
    control loop over (fleet 2, model 2) for the attention kernels,
    mamba2-1.3b's f32 loop over (fleet 1, model 2) for ssd_scan), its
    parity and times at the split shapes."""
    g = served["granite-3-8b"]["mesh"]["model_axis"]
    m = served[SSM_ARCHS[0]]["model_axis"]
    for kernel in ("flash_decode", "flash_attention", "ssd_scan"):
        counted, of = (m, f"{SSM_ARCHS[0]}'s f32 control loop at 2 layers "
                          "over (fleet 1, model 2) on cuda:0") \
            if kernel == "ssd_scan" else \
            (g, "granite-3-8b's control loop over (fleet 2, model 2) on "
                "cuda:0")
        rows[kernel]["model_axis"] = dict(
            launches=counted["launches"][kernel], launches_of=of,
            **g["kernels"][kernel])


# ------------------------------------------------------------ phase 14(e)
# a mesh axis that names no part of the fleet slab ('seq'): the slab is
# replicated over it, and each row block runs on its index 0, so the row
# blocks are those of phase 14(b)'s (fleet 2) run
SEQ_AXIS_MESH = ((2, 2), ("fleet", "seq"))
SEQ_AXIS_BUDGET_S = 20.0


def phase_replicated_axis(torch, ops, cfg, model, params, small,
                          fleet_only) -> dict:
    """Phase 14(e) for granite-3-8b. Phase 6's control loop at full width
    and depth, bf16, over (fleet 2, seq 2), every device cuda:0, counted
    and sync-checked as phase 6: its decode, admission and sync counts
    (per tick too) and its flash_decode and flash_attention launches equal
    those of phase 14(b)'s (fleet 2) run, and at 2 layers in f32 its
    digest equals that run's. Fails past ``SEQ_AXIS_BUDGET_S``."""
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    mesh = _card_mesh(*SEQ_AXIS_MESH)
    run = phase_control(torch, ops, cfg, model, params, mesh=mesh)
    kernels = ("flash_decode", "flash_attention")
    diff = {k: (run[k], fleet_only[k]) for k in
            ("per_tick", "decode", "prefill", "syncs")
            if run[k] != fleet_only[k]}
    diff.update({k: (run["launches"][k], fleet_only["launches"][k])
                 for k in kernels
                 if run["launches"][k] != fleet_only["launches"][k]})
    log(f"[mesh] {cfg.name} bf16 over (fleet 2, seq 2) on cuda:0 ({CARD}): "
        f"decode dispatches {run['decode']}, admissions {run['prefill']}, "
        f"syncs {run['syncs']} ((fleet 2) run {fleet_only['decode']}, "
        f"{fleet_only['prefill']}, {fleet_only['syncs']}); launches "
        + ", ".join(f"{k} {run['launches'][k]} ((fleet 2) run "
                    f"{fleet_only['launches'][k]})" for k in kernels)
        + f"; peak slab bytes {run['peak_bytes']} ((fleet 2) run "
        f"{fleet_only['peak_bytes']}); streams differing from the (fleet 2) "
        f"run's {_differing(run['digest'], fleet_only['digest'])}/"
        f"{len(fleet_only['digest'])} (bf16); {run['tok_s']:.1f} tok/s "
        f"against {fleet_only['tok_s']:.1f}")
    if diff:
        raise AssertionError(f"(fleet 2, seq 2) differs from (fleet 2): "
                             f"{diff}")
    cfg2, model2, params2 = small
    out = serve.run_control_loop(_control_args(serve), cfg2, model2,
                                 params2, cache_dtype=torch.float32,
                                 mesh=mesh)
    same = _digest(out["fe"]) == fleet_only["f32_digest"]
    del out
    _free(torch)
    took = time.perf_counter() - t0
    log(f"[mesh] f32 full width, 2 layers, (fleet 2, seq 2): digest equal "
        f"to the (fleet 2) run's: {same}; phase 14(e): {took:.1f}s "
        f"(budget {SEQ_AXIS_BUDGET_S:.0f}s)")
    if not same:
        raise AssertionError("the (fleet 2, seq 2) f32 control loop differs")
    if took > SEQ_AXIS_BUDGET_S:
        raise AssertionError(f"phase 14(e) took {took:.1f}s, over its "
                             f"{SEQ_AXIS_BUDGET_S:.0f}s budget")
    return {"launches": run["launches"]}


# --------------------------------------------------------------- phase 13
# model training on the card (``repro_torch.launch.train``'s stack). The
# reference trains through no Pallas kernel, and neither does the port:
# einsum attention and ``ssd_chunked``, so no kernel launches
TRAIN_LOSS_RTOL = 1e-5     # card against CPU, each step's loss
TRAIN_GRAD_TOL = 1e-4      # card against CPU, of each leaf's largest |g|
# ... floored at this share of the tree's largest |g|: a leaf whose
# gradient is zero but for rounding (a key bias) is held to the floor
# (tests/test_torch_train_lm.py)
GRAD_NOISE_FLOOR = 1e-3
REMAT_RTOL = 1e-6          # remat="full" against "none", same inputs
ACCUM_TOL = dict(atol=5e-5, rtol=5e-4)   # tests/test_models.py:214-227
# full width, depth cut so that f32 params, gradients and two moments fit
# beside the activations: granite-3-8b 4 of 40 layers (0.998 B params, 16
# B a param = 16.0 GB), mamba2-1.3b 8 of 48
TRAIN_DEPTH = {"granite-3-8b": 4, "mamba2-1.3b": 8}
TRAIN_STEPS = {"granite-3-8b": 20, "mamba2-1.3b": 5}
TRAIN_B, TRAIN_S = 4, 1024
# the training CLI's runs: the reference's defaults, then a resume, then the
# other families at the 20m scale
CLI_STEPS, CLI_RESUME = 300, 320
CLI_100M = ["--scale", "100m", "--batch", "16", "--seq", "256",
            "--ckpt-every", "100"]
CLI_ARCHS = ("grok-1-314b", "llama4-maverick-400b-a17b", "zamba2-2.7b",
             "internvl2-2b", "whisper-base")


def _grad_err(got, want) -> float:
    """The largest |got - want| of a leaf over that leaf's largest |want|
    (floored at GRAD_NOISE_FLOOR of the tree's largest), over all leaves;
    ``got`` may lie on another device."""
    from repro_torch.core.tree import leaves

    gl, wl = leaves(got), leaves(want)
    if len(gl) != len(wl):
        raise AssertionError(f"{len(gl)} gradient leaves against {len(wl)}")
    scales = [w.abs().max().item() for w in wl]
    floor = GRAD_NOISE_FLOOR * max(scales)
    return max((g.to(w.device) - w).abs().max().item() / max(sc, floor)
               for g, w, sc in zip(gl, wl, scales))


def _markov_tokens(torch, vocab: int, batch: int, seq: int, n: int) -> list:
    from repro_torch.data.pipeline import DataLoader, MarkovCorpus

    loader = DataLoader(MarkovCorpus(vocab, seed=SEED), batch, seq,
                        seed=SEED)
    return [torch.from_numpy(next(loader)["tokens"]) for _ in range(n)]


def phase_train_parity(torch, ops) -> None:
    """13 (a) granite-3-8b reduced, the same weights (seed 0, made on the
    CPU) on the CPU and on the card, the same Markov batch: the first
    gradient within TRAIN_GRAD_TOL of each leaf's largest, then three
    AdamW steps (cosine schedule) whose losses agree to TRAIN_LOSS_RTOL.
    (b) The guard: a forward under grad through flash_attention,
    flash_decode or ssd_scan (backend "pallas") raises on the card, and
    launches nothing."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map, value_and_grad
    from repro_torch.models.attention import attention
    from repro_torch.models.model import make_model, make_train_step
    from repro_torch.models.optim import AdamW, cosine_schedule
    from repro_torch.models.ssd import mamba2_forward

    cfg = get_config("granite-3-8b").reduced()
    model = make_model(cfg)
    cpu = model.init(seed=SEED, device="cpu")
    tokens = _markov_tokens(torch, cfg.vocab_size, 8, 64, 1)[0]
    grads, losses = {}, {}
    for where, dev in (("cpu", "cpu"), ("card", "cuda")):
        params = tree_map(lambda t: t.to(dev), cpu)
        batch = {"tokens": tokens.to(dev)}
        _, grads[where] = value_and_grad(lambda p: model.loss(p, batch),
                                         params, has_aux=True)
        opt = AdamW(lr=cosine_schedule(1e-3, 1, 3), weight_decay=0.01)
        step, state, losses[where] = make_train_step(model, opt), \
            opt.init(params), []
        for _ in range(3):
            params, state, m = step(params, state, batch)
            losses[where].append(m["loss"].item())
    gerr = _grad_err(grads["card"], grads["cpu"])
    lerr = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                   losses["cpu"]))
    log(f"[train] card against CPU ({cfg.name}, 8 x 64 Markov tokens, f32, "
        f"TF32 off): first gradient's worst leaf error {gerr:.2e} of its "
        f"largest |g| (gate {TRAIN_GRAD_TOL}); 3 AdamW steps' losses "
        f"{['%.6f' % x for x in losses['card']]} against "
        f"{['%.6f' % x for x in losses['cpu']]}, worst relative {lerr:.2e} "
        f"(gate {TRAIN_LOSS_RTOL})")
    if gerr > TRAIN_GRAD_TOL or lerr > TRAIN_LOSS_RTOL:
        raise AssertionError("training on the card disagrees with the CPU")

    # (b) the guard, on the card
    card = tree_map(lambda t: t.cuda(), cpu)
    x = torch.randn(2, 16, cfg.d_model, device="cuda")
    scfg = get_config("mamba2-1.3b").reduced()
    smodel = make_model(scfg)
    sparams = smodel.init(seed=SEED, device="cuda")["layers"][0]["mamba"]
    q = torch.randn(2, cfg.num_kv_heads, 2, cfg.resolved_head_dim,
                    device="cuda")
    kv = torch.randn(2, 16, cfg.num_kv_heads, cfg.resolved_head_dim,
                     device="cuda")
    pos = torch.full((2,), 15, dtype=torch.int32, device="cuda")
    cases = {
        "flash_attention": (lambda p: attention(
            p["layers"][0]["attn"], x, model.dims, rope_theta=1e4,
            backend="pallas").sum(), card),
        "ssd_scan": (lambda p: mamba2_forward(
            p, x, scfg, attn_backend="pallas").sum(), sparams),
        "flash_decode": (lambda t: ops.flash_decode(t, kv, kv, pos).sum(),
                         q),
    }
    before = dict(ops.LAUNCHES)
    for name, (fn, params) in cases.items():
        try:
            value_and_grad(fn, params)
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            raise AssertionError(f"{name} ran under grad on the card")
    if ops.LAUNCHES != before:
        raise AssertionError(f"the guard launched kernels: {ops.LAUNCHES}")
    log("[train] guard: flash_attention, ssd_scan and flash_decode under "
        "grad on the card raise 'no backward' and launch nothing")


def _step_busy_ms(torch, fn) -> tuple:
    """(device busy ms of one call of ``fn``, how it was read): the sum of
    the kernels' device times in a torch.profiler trace -- the kernel
    events' own, or where the trace lists none, the device time that the
    CPU ops launched themselves (a kernel event also counts under its
    launching op, so summing both counts every kernel twice) -- or
    (None, ...) when the trace shows no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA)
    launched = sum(e.self_device_time_total for e in events
                   if e.device_type == DeviceType.CPU)
    if kernels > 0:
        return kernels / 1e3, "kernel events"
    if launched > 0:
        return launched / 1e3, "device time under the CPU ops"
    return None, "no device time in the trace"


def _timed_step(torch, fn) -> tuple:
    """(result, host ms, device ms between CUDA events around the call) of
    one call of ``fn``, which returns a train step's (params, state,
    metrics) or an update's (params, state, stats): the host clock runs to
    the readback of the step's loss (the CLI's read) or, for an update,
    to the end of its work."""
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e0.record()
    out = fn()
    e1.record()
    if "loss" in out[2]:
        out[2]["loss"].item()
    else:
        torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3
    return out, host, e0.elapsed_time(e1)


def phase_train_full(torch, ops, smi) -> dict:
    """13 (c) granite-3-8b at full width, depth TRAIN_DEPTH, f32 params and
    moments, TRAIN_B x TRAIN_S Markov tokens: remat="full" against "none"
    on one batch (loss and gradients within REMAT_RTOL, lower peak
    memory), grad_accum=2 against 1 (params within ACCUM_TOL), then
    TRAIN_STEPS steps (the loss must fall), counted (no kernel launches),
    with tok/s, host against device ms, idle share, the optimizer's share,
    peak memory and f32 MFU. (d) mamba2-1.3b at full width, its depth cut,
    a few steps. Returns the numbers."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves, value_and_grad
    from repro_torch.models.model import make_model, make_train_step
    from repro_torch.models.optim import AdamW, cosine_schedule

    out = {}
    for name, depth in TRAIN_DEPTH.items():
        cfg = dataclasses.replace(get_config(name), num_layers=depth)
        model = make_model(cfg)
        steps = TRAIN_STEPS[name]
        t0 = time.perf_counter()
        params = model.init(seed=SEED, dtype=torch.float32, device="cuda")
        n_params = sum(p.numel() for p in leaves(params))
        toks = [t.cuda() for t in _markov_tokens(
            torch, cfg.vocab_size, TRAIN_B, TRAIN_S, steps)]
        opt = AdamW(lr=cosine_schedule(3e-4, 2, steps), weight_decay=0.01)
        state = opt.init(params)
        step = make_train_step(model, opt)
        torch.cuda.synchronize()
        log(f"[train] {name}: {_describe(cfg)} (depth cut from "
            f"{get_config(name).num_layers}), {n_params / 1e9:.3f} B params "
            f"f32, AdamW f32 moments; B {TRAIN_B} x S {TRAIN_S} Markov "
            f"tokens; built in {time.perf_counter() - t0:.1f}s")
        b0 = {"tokens": toks[0]}
        if name == "granite-3-8b":
            peaks, res = {}, {}
            for remat in ("none", "full"):
                m = make_model(cfg, remat=remat)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                (loss, _), g = value_and_grad(lambda p: m.loss(p, b0),
                                              params, has_aux=True)
                torch.cuda.synchronize()
                # above what was held before: the other run's gradient too
                peaks[remat] = (torch.cuda.max_memory_allocated()
                                - base) / 1e9
                res[remat] = (loss.item(), g)
                del g
            rl = abs(res["full"][0] - res["none"][0]) / abs(res["none"][0])
            rg = _grad_err(res["full"][1], res["none"][1])
            del res
            _free(torch)
            log(f"[train] remat full against none: loss rel {rl:.2e}, "
                f"gradients {rg:.2e} of each leaf's largest (gate "
                f"{REMAT_RTOL}); the gradient's peak memory above the params "
                f"{peaks['full']:.2f} GB against {peaks['none']:.2f}")
            if rl > REMAT_RTOL or rg > REMAT_RTOL \
                    or not peaks["full"] < peaks["none"]:
                raise AssertionError("remat='full' differs from 'none' or "
                                     "saves no memory")
            p1, _, _ = step(params, state, b0)
            p2, _, _ = make_train_step(model, opt, grad_accum=2)(
                params, state, b0)
            worst = 0.0
            for a, b in zip(leaves(p2), leaves(p1)):
                over = (a - b).abs() - ACCUM_TOL["rtol"] * b.abs()
                worst = max(worst, over.max().item())
            del p1, p2
            _free(torch)
            log(f"[train] grad_accum=2 against 1, one update: worst "
                f"|diff| - rtol x |p| {worst:.2e} (atol {ACCUM_TOL['atol']}, "
                f"rtol {ACCUM_TOL['rtol']})")
            if worst > ACCUM_TOL["atol"]:
                raise AssertionError("grad_accum=2 differs from 1")
        ops.reset_launches()
        losses, host, span, peaks, held = [], [], [], [], []
        for tok in toks:
            torch.cuda.reset_peak_memory_stats()
            (params, state, m), h, d = _timed_step(
                torch, lambda: step(params, state, {"tokens": tok}))
            losses.append(m["loss"].item())
            host.append(h)
            span.append(d)
            peaks.append(torch.cuda.max_memory_allocated() / 1e9)
            held.append(torch.cuda.memory_allocated() / 1e9)
        peak = max(peaks)
        launched = dict(ops.LAUNCHES)
        if any(launched.values()):
            raise AssertionError(f"training launched kernels: {launched}")
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"{name}: losses {losses} do not fall")
        step_ms = statistics.median(host[1:])
        tok_s = TRAIN_B * TRAIN_S / (step_ms / 1e3)
        row = dict(first=losses[0], last=losses[-1], step_ms=step_ms,
                   span_ms=statistics.median(span[1:]), tok_s=tok_s,
                   peak_gb=peak, n_params=n_params)
        line = (f"[train] {name}: {steps} steps, loss {losses[0]:.4f} -> "
                f"{losses[-1]:.4f}; step host {step_ms:.1f} ms (median of "
                f"{steps - 1}), CUDA-event span {row['span_ms']:.1f} ms; "
                f"{tok_s:,.0f} tok/s; launches of the kernels 0; peak "
                f"{peak:.2f} GB (a step's peak {peaks[0]:.2f} first, "
                f"{min(peaks[1:]):.2f}-{max(peaks[1:]):.2f} later; held "
                f"between steps {min(held):.2f}-{max(held):.2f} GB)")
        if name == "granite-3-8b":
            b = {"tokens": toks[-1]}
            busy, how = _step_busy_ms(torch, lambda: step(params, state, b))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            (_, _), g = value_and_grad(lambda p: model.loss(p, b), params,
                                       has_aux=True)
            torch.cuda.synchronize()
            grad_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
            upd_ms = []
            for _ in range(3):
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                upd_ms.append(_timed_step(
                    torch, lambda: opt.update(g, state, params))[2])
                upd_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
            del g
            upd_ms = statistics.median(upd_ms)
            flops = 6 * n_params * TRAIN_B * TRAIN_S
            row.update(busy_ms=busy, update_ms=upd_ms, grad_peak_gb=grad_peak,
                       update_peak_gb=upd_peak,
                       mfu=flops / (step_ms / 1e3) / F32_FLOPS_PER_S)
            line += (f" (reckoned: params and two moments "
                     f"{12 * n_params / 1e9:.1f} GB; the gradient reached "
                     f"{grad_peak:.2f} GB above them (its tree "
                     f"{4 * n_params / 1e9:.1f}, then activations), the "
                     f"update {upd_peak:.2f} GB above them and the "
                     f"gradient (new params and moments "
                     f"{12 * n_params / 1e9:.1f}, then temporaries)); device "
                     f"busy "
                     + (f"{busy:.1f} ms ({how}), idle share "
                        f"{1 - busy / row['span_ms']:.3f} of the event span"
                        if busy else f"not measured ({how})")
                     + f"; AdamW update {upd_ms:.1f} ms device span "
                     f"({upd_ms / step_ms:.1%} of the step); "
                     f"{flops / 1e12:.1f} TFLOP a step (6 x params x "
                     f"tokens): f32 MFU {row['mfu']:.3f} of "
                     f"{F32_FLOPS_PER_S / 1e12:.0f} TFLOP/s; {smi}")
        log(line)
        out[name] = row
        del params, state, step, toks
        _free(torch)
    return out


def _run_cli(argv) -> tuple:
    """``python -m repro_torch.launch.train`` in this process: (its
    stdout, wall seconds, the --out JSON)."""
    import contextlib
    import io
    import tempfile

    from repro_torch.launch import train

    with tempfile.TemporaryDirectory() as tmp:
        res = Path(tmp) / "r.json"
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            train.main(argv + ["--out", str(res)])
        wall = time.perf_counter() - t0
        return buf.getvalue(), wall, json.loads(res.read_text())


def phase_train_cli(torch, ops, smi) -> dict:
    """13 (e) the training CLI at the reference's defaults (granite-3-8b at the
    100m scale, 300 steps of 16 x 256) with checkpoints: the final loss
    below 0.75 x the first, reported beside the unigram entropy; rerun to
    320 steps, it resumes from step 300. Then each other family at the
    20m scale for 20 steps: losses finite and falling."""
    import shutil
    import tempfile

    ckpt = tempfile.mkdtemp(prefix="train_ckpt_")
    out = {}
    try:
        argv = CLI_100M + ["--steps", str(CLI_STEPS), "--ckpt-dir", ckpt]
        ops.reset_launches()
        text, wall, r = _run_cli(argv)
        last = [ln for ln in text.splitlines() if ln.startswith("[train]")]
        for ln in last[:2] + last[-2:]:
            log(f"  {ln}")
        first, final, uni = r["losses"][0], r["final"], r["unigram_entropy"]
        tok_s = CLI_STEPS * 16 * 256 / wall
        log(f"[train] python -m repro_torch.launch.train {' '.join(argv[:-2])}"
            f": {wall:.1f}s ({tok_s:,.0f} tok/s over the run, checkpoints "
            f"included); final {final:.4f} against 0.75 x first "
            f"{0.75 * first:.4f}; unigram entropy {uni:.3f}: the final loss "
            f"is {'below' if final < uni else 'NOT below'} it (the "
            f"reference's docstring claims 'well below'; checked, not "
            f"gated); {smi}")
        if not final < 0.75 * first:
            raise AssertionError("the 100m run's loss did not fall to 0.75x")
        text2, wall2, r2 = _run_cli(CLI_100M + [
            "--steps", str(CLI_RESUME), "--ckpt-dir", ckpt])
        said = f"resumed from step {CLI_STEPS}"
        if said not in text2 or len(r2["losses"]) != CLI_RESUME - CLI_STEPS:
            raise AssertionError(f"no resume from step {CLI_STEPS}:\n{text2}")
        log(f"[train] rerun to {CLI_RESUME} steps: '{said}', "
            f"{CLI_RESUME - CLI_STEPS} steps, {wall2:.1f}s; final "
            f"{r2['final']:.4f}")
        out["100m"] = dict(first=first, final=final, unigram=uni,
                           wall=wall, tok_s=tok_s)
        for arch in CLI_ARCHS:
            _, wall, r = _run_cli(["--arch", arch, "--scale", "20m",
                                   "--steps", "20"])
            ls = r["losses"]
            log(f"[train] {arch} 20m: 20 steps, loss {ls[0]:.4f} -> final "
                f"{r['final']:.4f} (mean of the last 10), {wall:.1f}s")
            if not all(map(math.isfinite, ls)) or not r["final"] < ls[0]:
                raise AssertionError(f"{arch}: losses {ls} do not fall")
            out[arch] = dict(first=ls[0], final=r["final"], wall=wall)
        if any(ops.LAUNCHES.values()):
            raise AssertionError(f"the training CLI launched kernels: "
                                 f"{dict(ops.LAUNCHES)}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return out


def phase_train(torch, ops, smi) -> dict:
    """Phase 13: model training on the card."""
    t0 = time.perf_counter()
    phase_train_parity(torch, ops)
    _free(torch)
    out = phase_train_full(torch, ops, smi)
    out["cli"] = phase_train_cli(torch, ops, smi)
    _free(torch)
    log(f"[train] phase 13: {time.perf_counter() - t0:.1f}s")
    return out


# phase 15: the parameter half of multi-device
SHARD_STEPS = 3
SHARD_RTOL = 1e-5            # sharded against plain step, loss and grad norm
# (c): the checkpointed state's depth (granite-3-8b's 0.40 B params at one
# layer, 4.8 GB with its two moments; at (a)'s four layers, 12.0 GB, the
# save and the restore together outrun the phase's budget), and the step
# it is saved after
CKPT_DEPTH = 1
CKPT_AT = 2
CKPT_BUDGET_S = 30.0
# the dry-run's cells: (label, CLI arguments); each runs in its own process.
# Both full-depth cells pin --grad-accum 1: at the reference's sizing
# (granite 8 microbatches, grok 4) granite's cell traced in 126.8 s alone
# on an H100 80GB (700 W) host, over this phase's budget, and each
# microbatch repeats the same traced work
DRYRUN_CELLS = (      # (label, arch, shape, mesh, run_cell's opts)
    ("granite-3-8b train_4k single (16 x 16 = 256 fake ranks), "
     "grad_accum pinned to 1",
     "granite-3-8b", "train_4k", "single", {"grad_accum": 1}),
    ("grok-1-314b train_4k multi, experts over data (2 x 16 x 16 = 512), "
     "grad_accum pinned to 1",
     "grok-1-314b", "train_4k", "multi",
     {"expert_sharding": "data", "grad_accum": 1}),
    ("(a)'s configuration on 1x1:data,model",
     "granite-3-8b", "train_4k", "single",
     {"mesh_spec": "1x1:data,model", "layers": TRAIN_DEPTH["granite-3-8b"],
      "global_batch": TRAIN_B, "seq_len": TRAIN_S, "param_dtype": "f32",
      "remat": "none", "loss_chunk": 2048}),
)
# one cell in a process of its own: argv arch, shape, mesh, opts (JSON),
# the JSON result's path
DRYRUN_CHILD = (
    "import json, sys\n"
    "from repro_torch.launch.dryrun import run_cell\n"
    "arch, shape, mesh, opts, out = sys.argv[1:]\n"
    "res = run_cell(arch, shape, mesh, json.loads(opts), device='cuda')\n"
    "open(out, 'w').write(json.dumps(res))\n")
DRYRUN_TIMEOUT = 110         # seconds, the three cells together


def _full(x):
    """A DTensor's whole value (every rank's blocks), else ``x``."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _shard_steps(torch, step, params, state, batches) -> dict:
    """``step`` over ``batches``: each step's loss and grad norm (read
    back whole), host ms to the loss's readback, CUDA-event ms, and the
    peak memory of the steps; the last params and optimizer state."""
    out = dict(loss=[], gnorm=[], host=[], dev=[], peak=[])
    for b in batches:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        params, state, m = step(params, state, b)
        e1.record()
        out["loss"].append(_full(m["loss"]).item())
        out["host"].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        out["dev"].append(e0.elapsed_time(e1))
        out["gnorm"].append(_full(m["grad_norm"]).item())
        out["peak"].append(torch.cuda.max_memory_allocated() / 1e9)
    out["params"], out["state"] = params, state
    return out


def phase_sharded_step(torch, ops, smi, train) -> dict:
    """15 (a): see the module docstring."""
    import socket

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves
    from repro_torch.distributed import (ShardPlan, make_shard_fn,
                                         place_params, reshard_params)
    from repro_torch.distributed.sharding import place_batch
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models.model import make_model, make_train_step
    from repro_torch.models.optim import AdamW, cosine_schedule

    name = "granite-3-8b"
    cfg = dataclasses.replace(get_config(name), num_layers=TRAIN_DEPTH[name])
    model = make_model(cfg)
    toks = [{"tokens": t.cuda()} for t in _markov_tokens(
        torch, cfg.vocab_size, TRAIN_B, TRAIN_S, SHARD_STEPS)]
    opt = AdamW(lr=cosine_schedule(3e-4, 2, SHARD_STEPS), weight_decay=0.01)
    params = model.init(seed=SEED, dtype=torch.float32, device="cuda")
    plain = _shard_steps(torch, make_train_step(model, opt), params,
                         opt.init(params), toks)
    del params, plain["params"], plain["state"]
    _free(torch)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_device_mesh((1, 1), ("data", "model"))
        plan = ShardPlan(mesh, "train")
        params = place_params(plan, model.init(seed=SEED,
                                               dtype=torch.float32,
                                               device="cuda"))
        batches = [place_batch(plan, b) for b in toks]
        ops.reset_launches()
        sharded = _shard_steps(
            torch, make_train_step(model, opt, make_shard_fn(plan)), params,
            opt.init(params), batches)
        launched = dict(ops.LAUNCHES)
        fresh = make_device_mesh((1, 1), ("data", "model"))
        moved = reshard_params(sharded["params"], ShardPlan(fresh, "train"))
        same = all(torch.equal(_full(a), _full(b)) for a, b in zip(
            leaves(sharded["params"]), leaves(moved)))
        placed = {str(tuple(p.placements))
                  for p in leaves(sharded["params"])}
        del params, moved, sharded["params"], sharded["state"]
        _free(torch)
        ckpt = phase_sharded_ckpt(torch, ops, smi, plan, opt, batches)
    finally:
        dist.destroy_process_group()
    _free(torch)
    worst = max(abs(a - b) / abs(b) for k in ("loss", "gnorm")
                for a, b in zip(sharded[k], plain[k]))
    for tag, r in (("plain", plain), ("sharded", sharded)):
        log(f"[shard] {tag}: losses "
            + ", ".join(f"{x:.6f}" for x in r["loss"]) + "; grad norms "
            + ", ".join(f"{x:.6f}" for x in r["gnorm"])
            + f"; step host {statistics.median(r['host'][1:]):.1f} ms, "
            f"CUDA-event {statistics.median(r['dev'][1:]):.1f} ms (median "
            f"of steps 2-{SHARD_STEPS}); peak {max(r['peak']):.2f} GB")
    p13 = train.get(name, {})
    log(f"[shard] (a) {name} at {TRAIN_DEPTH[name]} layers f32 B {TRAIN_B} "
        f"x S {TRAIN_S} on a one-rank NCCL (data=1, model=1) DeviceMesh, "
        f"params placed {sorted(placed)}: {SHARD_STEPS} steps, loss and "
        f"grad norm within {worst:.2e} relative of the plain step's (gate "
        f"{SHARD_RTOL}); kernel launches {launched}; resharded onto a fresh "
        f"(1, 1) mesh: {'equal bits' if same else 'DIFFERENT'}; phase 13's "
        f"step {p13.get('step_ms', float('nan')):.1f} ms host, "
        f"{p13.get('span_ms', float('nan')):.1f} ms CUDA-event, peak "
        f"{p13.get('peak_gb', float('nan')):.2f} GB; {smi}")
    if worst > SHARD_RTOL or not same or any(launched.values()):
        raise AssertionError("the sharded step differs from the plain one, "
                             "launched a kernel, or the reshard moved bits")
    return dict(plain=plain, sharded=sharded, worst=worst, ckpt=ckpt)


def phase_sharded_ckpt(torch, ops, smi, plan, opt, batches) -> dict:
    """15 (c): see the module docstring."""
    import os
    import shutil
    import tempfile

    from repro_torch.checkpoint.manager import restore_latest, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves
    from repro_torch.distributed import make_shard_fn, place_params
    from repro_torch.models.model import make_model, make_train_step

    t0 = time.perf_counter()
    name = "granite-3-8b"
    cfg = dataclasses.replace(get_config(name), num_layers=CKPT_DEPTH)
    model = make_model(cfg)
    step = make_train_step(model, opt, make_shard_fn(plan))
    params = place_params(plan, model.init(seed=SEED, dtype=torch.float32,
                                           device="cuda"))
    ops.reset_launches()
    first = _shard_steps(torch, step, params, opt.init(params),
                         batches[:CKPT_AT])
    del params
    state = {"params": first.pop("params"), "opt": first.pop("state")}
    ckpt = tempfile.mkdtemp(prefix="shard_ckpt_")
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        path = save_checkpoint(ckpt, CKPT_AT, state)
        save_ms = (time.perf_counter() - t) * 1e3
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        straight = _shard_steps(torch, step, state["params"], state["opt"],
                                batches[CKPT_AT:])
        del straight["params"], straight["state"]
        t = time.perf_counter()
        restored_at, got = restore_latest(ckpt, state)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t) * 1e3
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    del state
    whole = not any(hasattr(x, "full_tensor") for x in leaves(got))
    resumed = _shard_steps(
        torch, step, place_params(plan, got["params"]),
        dict(got["opt"], mu=place_params(plan, got["opt"]["mu"]),
             nu=place_params(plan, got["opt"]["nu"])), batches[CKPT_AT:])
    del got, resumed["params"], resumed["state"]
    launched = dict(ops.LAUNCHES)
    _free(torch)
    same = all(resumed[k] == straight[k] for k in ("loss", "gnorm"))
    took = time.perf_counter() - t0
    log(f"[shard] (c) {name} at {CKPT_DEPTH} layer(s) f32, the train state "
        f"after step {CKPT_AT} (DTensor params and moments on the one-rank "
        f"NCCL mesh) saved in {save_ms:.1f} ms host, {nbytes} bytes, "
        f"restored whole in {restore_ms:.1f} ms host (warm page cache), "
        f"re-placed with place_params: step {CKPT_AT + 1} loss "
        f"{resumed['loss'][0]!r} grad norm {resumed['gnorm'][0]!r} against "
        f"the uninterrupted {straight['loss'][0]!r} / "
        f"{straight['gnorm'][0]!r}: {'equal bits' if same else 'DIFFERENT'}"
        f"; kernel launches {launched}; {took:.1f}s (budget "
        f"{CKPT_BUDGET_S:.0f}s); {smi}")
    if not (same and whole and restored_at == CKPT_AT) or any(
            launched.values()):
        raise AssertionError("the resumed sharded step differs from the "
                             "uninterrupted one")
    if took > CKPT_BUDGET_S:
        raise AssertionError(f"phase 15(c) took {took:.1f}s, over its "
                             f"{CKPT_BUDGET_S:.0f}s budget")
    return dict(save_ms=save_ms, restore_ms=restore_ms, bytes=nbytes,
                seconds=took)


def phase_dryrun(torch, smi, measured_peak_gb: float) -> dict:
    """15 (b): see the module docstring."""
    import os
    import tempfile

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for i, (label, arch, shape, mesh, opts) in enumerate(DRYRUN_CELLS):
            path = Path(tmp) / f"cell{i}.json"
            cmd = [sys.executable, "-c", DRYRUN_CHILD, arch, shape, mesh,
                   json.dumps(opts), str(path)]
            procs.append((label, path, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env=env, cwd=str(ROOT))))
        t0 = time.perf_counter()
        failed = []
        for label, path, p in procs:
            left = max(DRYRUN_TIMEOUT - (time.perf_counter() - t0), 1)
            try:
                text, _ = p.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                p.kill()
                text, _ = p.communicate()
                failed.append(f"{label}: over {DRYRUN_TIMEOUT}s")
                continue
            res = json.loads(path.read_text()) if path.exists() else {}
            if p.returncode != 0 or not res.get("ok"):
                failed.append(f"{label}: {res.get('error', text[-1500:])}")
                continue
            out[label] = res
            m = res["memory"]
            log(f"[dryrun] {label}: peak {m['peak_hbm_bytes'] / 1e9:.2f} GB a "
                f"device (arguments {m['argument_bytes'] / 1e9:.2f} GB), "
                f"{res['flops_per_device']:.4g} flops a device, collectives "
                f"{res['collectives']['total'] / 2**20:.1f} MiB a device ("
                + ", ".join(f"{k} {v / 2**20:.1f}" for k, v in
                            res["collectives"].items() if k != "total" and v)
                + f"); grad_accum {res['opts']['grad_accum']}, loss_chunk "
                f"{res['opts']['loss_chunk']}, remat {res['opts']['remat']}; "
                f"traced in {res['trace_s']} s")
    if failed:
        raise AssertionError("dry-run cells failed: " + " | ".join(failed))
    pred = out[DRYRUN_CELLS[2][0]]["memory"]["peak_hbm_bytes"] / 1e9
    log(f"[dryrun] (a)'s configuration: predicted peak {pred:.2f} GB a "
        f"device against (a)'s measured max_memory_allocated "
        f"{measured_peak_gb:.2f} GB ({pred / measured_peak_gb:.3f}x); {smi}")
    return out


def phase_multi_device(torch, ops, smi, train) -> dict:
    """Phase 15: the parameter half of multi-device."""
    t0 = time.perf_counter()
    a = phase_sharded_step(torch, ops, smi, train)
    b = phase_dryrun(torch, smi, max(a["sharded"]["peak"]))
    log(f"[shard] phase 15: {time.perf_counter() - t0:.1f}s")
    return dict(step=a, dryrun=b)


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
    from repro_torch.kernels import build, ops, ref

    global CARD
    t_start = time.perf_counter()
    smi = CARD = phase_card(torch)
    phase_build(build)
    errs = phase_parity(torch, ops, ref)
    errs["ssd_decode"], ssd_decode_row = phase_ssd_decode(torch, ops, ref)
    variant_errs = phase_parity_variants(
        torch, ops, ref, torch.Generator(device="cuda").manual_seed(SEED + 5))

    served = {}
    for name in SERVED:
        served[name] = serve_arch(torch, F, ops, ref, get_config(name))
        _free(torch)
    rows = dict(served["granite-3-8b"]["rows"])
    rows.update(phase_times_ssm(torch, F, ops, ref, served))
    launches = dict(served["granite-3-8b"]["launches"])
    for kernel in ("ssd_scan", "ssd_decode"):
        launches[kernel] = served[SSM_ARCHS[0]]["launches"][kernel]
    rows["ssd_decode"] = ssd_decode_row
    # this round's variants, beside each kernel's row: their times at the
    # chunk and int8 paths' shapes, their parity, and their launches on
    # those paths (granite's control loop with --chunk-len 4 and with int8
    # replicas, mamba2's with --chunk-len 4)
    vtimes = phase_times_variants(torch, F, ops, ref, served)
    g_chunk = served["granite-3-8b"]["chunk"]
    m_chunk = served[SSM_ARCHS[0]]["chunk"]
    g_int8 = served["granite-3-8b"]["int8"]
    variants = {
        "flash_attention": ("q_offset", g_chunk["control_chunk_calls"]
                            * get_config("granite-3-8b").num_layers,
                            "chunk dispatches of granite-3-8b's control "
                            "loop with --chunk-len 4, one a layer"),
        "ssd_scan": ("init_state", m_chunk["control_chunk_calls"]
                     * get_config(SSM_ARCHS[0]).num_layers,
                     "chunk dispatches of mamba2-1.3b's control loop with "
                     "--chunk-len 4, one a layer"),
        "flash_decode": ("int8", g_int8["control_launches"]["flash_decode"],
                         "every decode launch of granite-3-8b's control "
                         "loop with int8 replicas"),
    }
    for name, (vname, n, of) in variants.items():
        rows[name]["variants"] = {vname: dict(
            launches=n, launches_of=of, max_abs_err=variant_errs[name],
            **vtimes[name])}
    # the MoE family: the attention kernels at its heads (qpg 6 and 5),
    # with their launches on its paths (grok-1-314b's control loop, and
    # llama4-maverick's drain run, which is all it runs)
    moe_runs = {}
    for name in MOE_ARCHS:
        moe_runs[name] = serve_moe(torch, F, ops, ref, get_config(name), smi)
        _free(torch)
    for kernel in ("flash_decode", "flash_attention"):
        rows[kernel]["moe"] = {}
        for name, run in moe_runs.items():
            L = run["cfg"].num_layers
            counted = run.get("control", {}).get("launches", run["drain"])
            of = ("its control loop" if "control" in run
                  else "its drain run") + f" at {L} layers"
            shape = ("drain pool, 8 slots" if kernel == "flash_decode"
                     else "single admit, the longest prompt")
            rows[kernel]["moe"][name] = dict(
                launches=counted[kernel], launches_of=of,
                timed_at=shape, **run[kernel])
    _free(torch)
    t_sim = time.perf_counter()
    rows["gcn_layer_bwd"], errs["gcn_layer_bwd"], exp, fwd = phase_sim(
        torch, ops, ref)
    rows["gcn_layer"]["update"] = {f"N{n}": r for n, r in fwd.items()}
    # the experiment is this kernel's main path (and the GCN's second)
    of = (f"python -m repro_torch.sim.experiment: {exp['ticks']} OURS "
          f"ticks, {exp['updates']} DDPG updates")
    launches["gcn_layer_bwd"] = exp["launches"]["gcn_layer_bwd"]
    rows["gcn_layer_bwd"]["launches_of"] = of
    rows["gcn_layer"]["experiment"] = dict(
        launches=exp["launches"]["gcn_layer"], launches_of=of)
    log(f"[sim] phase 11: {time.perf_counter() - t_sim:.1f}s")
    _free(torch)
    families = phase_families(torch, F, ops, ref, smi, errs)
    extras_rows(rows, families)
    fleet_rows(rows, families, served["granite-3-8b"]["mesh"])
    model_axis_rows(rows, served)
    _free(torch)
    train = phase_train(torch, ops, smi)
    _free(torch)
    phase_multi_device(torch, ops, smi, train)
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
