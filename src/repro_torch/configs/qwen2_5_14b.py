"""qwen2.5-14b [dense] — hf:Qwen/Qwen2.5 family.

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064 — GQA, QKV bias.
40 heads is not divisible by TP=16; the shard plan pads q-heads per kv-group
(see repro_torch.models.dims.PaddedDims).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    max_seq_len=131_072,
))
