"""whisper-base [audio] — arXiv:2212.04356 (enc-dec; conv/mel frontend
STUBBED); a copy of ``repro.configs.whisper_base``.

6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865. The encoder consumes
precomputed frame embeddings (1, 1500, 512), each request's
``frame_embeds`` extra -- the conv1d/mel frontend is a stub. GELU MLPs
(original whisper uses GELU, not SwiGLU).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,              # decoder layers
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    activation="gelu",
    tie_embeddings=True,
    is_encoder_decoder=True,
    encoder_layers=6,
    encoder_seq_len=1500,
    rope_theta=0.0,            # whisper uses absolute positions, not RoPE
    max_seq_len=32768,         # the reference's, sized for its 32k cell
))
