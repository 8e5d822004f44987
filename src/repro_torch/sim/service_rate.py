"""Per-replica service rates from each arch's decode roofline (the port of
``repro.sim.service_rate``, with the hardware as arguments).

A "replica" is ``chips`` accelerators serving decode together. Throughput
model (decode, batch B requests in flight):

    step_time = max( compute:  2·N_active·B / (chips·peak_flops),
                     memory:   weight_bytes/(chips·hbm_bw)
                               + B·kv_bytes_per_token·context/(chips·hbm_bw) )
    tokens/s  = B / step_time,   requests/s = tokens/s / avg_decode_len

The defaults describe one NVIDIA H100 SXM (NVIDIA's data sheet: 989
TFLOP/s dense bf16, 3.35 TB/s of HBM) as a one-chip replica. The
reference's defaults describe a 16-chip slice of its own accelerator; pass
its constants to reproduce its rates. The fluid experiment
(``sim.experiment``) takes a fixed ``unit_capacity`` and does not call
this module.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12          # bf16 / chip (H100 SXM, dense)
HBM_BW = 3.35e12             # bytes/s / chip
CHIPS_PER_REPLICA = 1
DEFAULT_BATCH = 64
AVG_DECODE_LEN = 128


def kv_bytes_per_token(cfg, kv_dtype_bytes: int = 2) -> float:
    if cfg.family in ("ssm", "hybrid", "hybrid_moe"):
        # mamba state is O(1); per-token HBM traffic ~ state read/write
        n_ssm = cfg.layer_types.count("mamba") \
            if cfg.family == "hybrid_moe" else cfg.num_layers
        state = n_ssm * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
        n_attn = 0
        if cfg.family == "hybrid" and cfg.attn_every:
            n_attn = (cfg.num_layers + cfg.attn_every - 1) // cfg.attn_every
        elif cfg.family == "hybrid_moe":
            n_attn = cfg.layer_types.count("attention")
        extra = 2 * n_attn * cfg.num_kv_heads * cfg.resolved_head_dim * \
            kv_dtype_bytes
        return state / 1000.0 + extra  # state reread amortized over context
    layers = cfg.num_layers
    return 2 * layers * cfg.num_kv_heads * cfg.resolved_head_dim * \
        kv_dtype_bytes


def replica_decode_rate(cfg, batch: int = DEFAULT_BATCH,
                        context: int = 4096, *,
                        peak_flops: float = PEAK_FLOPS,
                        hbm_bw: float = HBM_BW,
                        chips: int = CHIPS_PER_REPLICA) -> float:
    """Decode tokens/sec of one replica of ``chips`` chips."""
    n_active = cfg.active_param_count()
    weight_bytes = n_active * 2
    flops_per_tok = 2 * n_active
    compute_t = flops_per_tok * batch / (chips * peak_flops)
    kv_traffic = batch * kv_bytes_per_token(cfg) * context
    memory_t = (weight_bytes + kv_traffic) / (chips * hbm_bw)
    step_t = max(compute_t, memory_t)
    return batch / step_t


def replica_request_rate(cfg, batch: int = DEFAULT_BATCH,
                         context: int = 4096,
                         decode_len: int = AVG_DECODE_LEN,
                         **hardware) -> float:
    """Requests/sec of one replica (a simulator's unit_capacity);
    ``hardware`` is ``replica_decode_rate``'s peak_flops, hbm_bw, chips."""
    return replica_decode_rate(cfg, batch, context, **hardware) / decode_len
