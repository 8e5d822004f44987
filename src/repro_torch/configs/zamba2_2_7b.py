"""zamba2-2.7b [hybrid] — arXiv:2411.15242.

54 Mamba-2 layers, d_model=2560, d_ff=10240, vocab=32000, ssm_state=64, plus a
SHARED attention block (32H, kv=32, head_dim=80) invoked every 6 layers
(9 invocations, each with its own KV cache, shared weights). Sub-quadratic
decode -> runs the long_500k shape. See DESIGN.md §5 for simplifications vs.
the real Zamba-2 (no embedding-concat / per-invocation LoRA).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    tie_embeddings=True,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
    rope_theta=10_000.0,
    max_seq_len=1_048_576,
))
