"""llama4-maverick-400b-a17b [moe] — hf:meta-llama/Llama-4 family (unverified).

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128 experts top-1.
Maverick-style: MoE FFN on alternating layers (dense on the rest) plus an
always-on shared expert — this lands total params ~400B with ~17B active.
40 heads padded per kv-group for TP=16 (PaddedDims).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    num_experts=128,
    num_experts_per_tok=1,
    moe_every=2,
    moe_shared_expert=True,
    rope_theta=500_000.0,
    max_seq_len=131_072,
))
