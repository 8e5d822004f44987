"""grok-1-314b [moe] — hf:xai-org/grok-1 (unverified tier).

64L d_model=6144 48H (GQA kv=8) head_dim=128 d_ff=32768 vocab=131072,
MoE 8 experts top-2 on every layer.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    num_experts=8,
    num_experts_per_tok=2,
    moe_every=1,
    rope_theta=10_000.0,
    max_seq_len=8192 * 16,
))
