"""mamba2-1.3b [ssm] — arXiv:2405.21060 (SSD / state-space duality).

48L d_model=2048 attention-free, vocab=50280, ssm_state=128, expand=2
(d_inner=4096, head_dim=64 -> 64 SSD heads). O(1) decode state -> runs
long_500k. vocab padded for TP=16 by the shard plan.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    max_seq_len=1_048_576,
))
