"""internvl2-2b [vlm] — arXiv:2404.16821 (InternViT frontend STUBBED); a
copy of ``repro.configs.internvl2_2b``.

LM backbone (InternLM2-1.8B-like): 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553. The ViT produces 1025 patch embeddings (stub: each request
carries precomputed (1, 1025, 2048) patch embeddings as its
``patch_embeds`` extra) which are prepended to the text sequence.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    num_patches=1025,
    rope_theta=1_000_000.0,
    max_seq_len=131_072,
))
