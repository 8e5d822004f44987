"""Architecture/config system (a copy of ``repro.configs.base``).

Every assigned architecture is expressed as an ``ArchConfig``. The model substrate
(`repro_torch.models`) consumes these; the launchers select them via
``--arch <id>``. The port serves every family below; vlm and audio are
served through the engine API (requests carrying their per-request
extras), as in the reference, whose CLI does not reach them either.

Families:
  dense   — decoder-only transformer (GQA, SwiGLU)
  moe     — decoder-only transformer with top-k mixture-of-experts FFNs
  hybrid  — Mamba-2 backbone with a shared attention block every `attn_every` layers
  hybrid_moe — Mamba-2 and attention layers side by side (``layer_types``),
            each with its own weights and each followed by a dropless top-k
            MoE FFN plus an always-on shared expert (granitemoehybrid)
  ssm     — pure Mamba-2 (attention-free)
  vlm     — dense LM backbone consuming stub patch embeddings + text tokens
  audio   — encoder-decoder transformer (Whisper-style); conv/mel frontend stubbed
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str      # dense | moe | hybrid | hybrid_moe | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                   # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    activation: str = "swiglu"       # swiglu | gelu
    norm_eps: float = 1e-5
    rope_theta: float = 1_000_000.0
    max_seq_len: int = 131_072
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim (0 -> d_ff)
    moe_every: int = 1               # MoE FFN every k-th layer (others dense)
    moe_shared_expert: bool = False  # always-on shared expert on MoE layers
    capacity_factor: float = 1.25
    # --- SSM (Mamba-2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_groups: int = 1
    ssm_chunk: int = 256
    # --- hybrid ---
    attn_every: int = 0              # shared attn block every k layers (0 = never)
    # --- encoder-decoder (audio) ---
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 0         # whisper: 1500 frames
    # --- vlm ---
    num_patches: int = 0             # stub patch embeddings prepended to text
    # --- hybrid_moe (the port's own fields; the neutral defaults leave
    # every other family as it is, and only hybrid_moe reads them) ---
    layer_types: tuple = ()          # per layer "mamba" or "attention"
    experts_held: int = 0            # experts [0, held) computed here; 0 = all
    attention_multiplier: float = 0.0    # softmax scale; 0 -> 1/sqrt(hd)
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0      # logits are divided by it
    position_embedding_type: str = "rope"    # "rope" | "nope"

    def __post_init__(self):
        # a JSON configuration gives a list: keep the frozen config hashable
        object.__setattr__(self, "layer_types", tuple(self.layer_types))

    # ------------------------------------------------------------------ derived
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def d_inner(self) -> int:
        """Mamba-2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def sub_quadratic(self) -> bool:
        """True when decode cost/state is O(1)-ish in context (SSM/hybrid)."""
        return self.family in ("ssm", "hybrid", "hybrid_moe")

    @property
    def held_experts(self) -> int:
        """Experts whose weights this model holds and computes: ids
        [0, held)."""
        return self.experts_held or self.num_experts

    @property
    def softmax_scale(self) -> float:
        """Attention's softmax scale: ``attention_multiplier``, else
        1/sqrt(head_dim)."""
        return self.attention_multiplier \
            or 1.0 / math.sqrt(self.resolved_head_dim)

    @property
    def has_attention(self) -> bool:
        if self.family == "hybrid_moe":
            return "attention" in self.layer_types
        return self.family != "ssm"

    @property
    def uses_moe(self) -> bool:
        return self.num_experts > 0

    # ------------------------------------------------------------ param counts
    def param_count(self) -> int:
        """Analytic parameter count (logical, unpadded). Used by tests + roofline."""
        d, v = self.d_model, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "hybrid_moe":
            return emb + d + sum(self._hybrid_moe_layer(t)
                                 for t in self.layer_types)
        if self.family in ("ssm", "hybrid"):
            n = emb
            di, N, G, H = self.d_inner, self.ssm_state, self.ssm_groups, self.ssm_heads
            in_proj = d * (2 * di + 2 * G * N + H)
            conv = self.ssm_conv_width * (di + 2 * G * N)
            out_proj = di * d
            per_layer = in_proj + conv + out_proj + di + 2 * H + d  # norm+A,D,dt_bias
            n += self.num_layers * per_layer
            if self.family == "hybrid" and self.attn_every:
                hd = self.resolved_head_dim
                qk = d * self.num_heads * hd + d * self.num_kv_heads * hd
                vo = d * self.num_kv_heads * hd + self.num_heads * hd * d
                mlp = 3 * d * self.d_ff
                n += qk + vo + mlp + 2 * d  # one shared block
            n += d  # final norm
            return n
        hd = self.resolved_head_dim
        attn = (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                + self.num_heads * hd * d)
        if self.qkv_bias:
            attn += (self.num_heads + 2 * self.num_kv_heads) * hd
        mlp_mult = 3 if self.activation == "swiglu" else 2
        dense_mlp = mlp_mult * d * self.d_ff
        n = emb + d  # embeddings + final norm
        if self.is_encoder_decoder:
            enc_layer = attn + dense_mlp + 2 * d
            dec_layer = 2 * attn + dense_mlp + 3 * d  # self + cross
            n += self.encoder_layers * enc_layer + self.num_layers * dec_layer
            n += self.encoder_seq_len * 0  # sinusoidal enc pos: not learned
            n += self.max_decoder_pos * d  # learned decoder positions
            return n
        for layer in range(self.num_layers):
            n += attn + 2 * d
            if self.uses_moe and layer % self.moe_every == 0:
                e_ff = self.moe_d_ff or self.d_ff
                n += self.num_experts * mlp_mult * d * e_ff + d * self.num_experts
                if self.moe_shared_expert:
                    n += mlp_mult * d * e_ff
            else:
                n += dense_mlp
        return n

    def _mamba_params(self) -> int:
        """One Mamba-2 mixer with its pre-norm."""
        d, di, N, G, H = (self.d_model, self.d_inner, self.ssm_state,
                          self.ssm_groups, self.ssm_heads)
        in_proj = d * (2 * di + 2 * G * N + H)
        conv = (self.ssm_conv_width + 1) * (di + 2 * G * N)   # with bias
        return in_proj + conv + di * d + di + 2 * H + d

    def _hybrid_moe_layer(self, kind: str) -> int:
        """A hybrid_moe layer: its mixer and its MoE FFN (every expert, the
        router and the shared expert), both with their pre-norms."""
        d = self.d_model
        if kind == "mamba":
            mixer = self._mamba_params()
        else:
            hd = self.resolved_head_dim
            mixer = (2 * d * self.num_heads * hd
                     + 2 * d * self.num_kv_heads * hd + d)
        ffn = (self.num_experts * 3 * d * (self.moe_d_ff or self.d_ff)
               + d * self.num_experts + 3 * d * self.d_ff + d)
        return mixer + ffn

    @property
    def max_decoder_pos(self) -> int:
        # Learned decoder positions sized to the assigned shape set (the real
        # whisper-base table is 448; the assigned prefill_32k cell requires
        # 32k — the +17M params are recorded in DESIGN.md §8).
        return max(self.max_seq_len, 4096) if self.is_encoder_decoder else 0

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts). Drives 6·N_active·D."""
        if not self.uses_moe:
            return self.param_count()
        d = self.d_model
        e_ff = self.moe_d_ff or self.d_ff
        mlp_mult = 3 if self.activation == "swiglu" else 2
        n_moe_layers = self.num_layers if self.family == "hybrid_moe" else \
            len([l for l in range(self.num_layers) if l % self.moe_every == 0])
        inactive = n_moe_layers * (self.num_experts - self.num_experts_per_tok) \
            * mlp_mult * d * e_ff
        return self.param_count() - inactive

    # ------------------------------------------------------------------ reduced
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests. A hybrid_moe keeps
        both layer kinds (four layers, one of them attention) and eight
        experts, four of them held where the config holds a share."""
        if self.family == "hybrid_moe":
            moe = dict(layer_types=("mamba", "mamba", "attention", "mamba"),
                       num_experts=min(self.num_experts, 8),
                       num_experts_per_tok=min(self.num_experts_per_tok, 3),
                       experts_held=min(self.experts_held, 4))
        else:
            moe = dict(num_experts=min(self.num_experts, 4),
                       num_experts_per_tok=min(self.num_experts_per_tok, 2))
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=min(self.num_layers,
                           4 if self.family in ("ssm", "hybrid",
                                                "hybrid_moe") else 2),
            d_model=128,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=32 if self.num_heads else 0,
            d_ff=256 if self.d_ff else 0,
            moe_d_ff=128 if self.moe_d_ff else 0,
            vocab_size=512,
            max_seq_len=512,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=32,
            attn_every=2 if self.attn_every else 0,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq_len=min(self.encoder_seq_len, 64),
            num_patches=min(self.num_patches, 16),
            **moe,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One dry-run cell's shape: sequence length, global batch and kind
    ("train" | "prefill" | "decode")."""
    name: str
    seq_len: int
    global_batch: int
    kind: str


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list:
    """The shape cells that apply to this arch (long_500k only for the
    sub-quadratic ones)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.sub_quadratic:
        out.append(SHAPES["long_500k"])
    return out


# Populated by repro_torch.configs.__init__
REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        import repro_torch.configs  # noqa: F401  (trigger registration)
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]
