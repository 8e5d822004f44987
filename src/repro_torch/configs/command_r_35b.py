"""command-r-35b [dense] — hf:CohereForAI/c4ai-command-r-v01 (unverified tier).

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000 — GQA, no bias.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    rope_theta=4_000_000.0,
    max_seq_len=131_072,
))
