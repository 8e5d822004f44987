"""Model facade: one API over the ported architecture families (the port of
``repro.models.model``'s serving half).

    model = make_model(get_config("granite-3-8b"))
    params = model.init(seed=0, dtype=torch.bfloat16, device="cuda")
    logits, state, pos = model.prefill(params, batch, cache_len=1024)
    logits, state = model.decode(params, state, tokens, pos)
    logits, state, pos = model.prefill_chunk(params, state, tokens,
                                             offsets, lengths)

The dense, moe, ssm and hybrid families are ported; the others raise
``ValueError``. ``cache_dtype="int8"`` (the quantized KV codec of
``serving.kv_quant``) is taken by the attention-LM families (dense, moe)
only, and chunked prefill is refused for moe (expert capacity would scale
with the chunk, not the prompt), as in the reference.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm, ssm_lm
from repro_torch.models.dims import PaddedDims, padded_dims

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid")
# serve-state leaves with a sequence axis (axis 2, after the layer and row
# axes: the attention caches, float or int8 with their scales); the others
# (SSM and conv state) are per row, whatever the prompt length
SEQ_LEAVES = ("k", "v", "attn_k", "attn_v", "k_q", "v_q", "k_s", "v_s")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    dims: PaddedDims

    def __post_init__(self):
        if self.cfg.family not in PORTED_FAMILIES:
            raise ValueError(f"family {self.cfg.family!r} "
                             f"({self.cfg.name}) is not yet ported")

    @property
    def _attn_lm(self) -> bool:
        """The attention-LM families (``models.lm``): dense and moe."""
        return self.cfg.family in ("dense", "moe")

    def init(self, seed: int = 0, dtype=torch.float32, device="cuda"):
        """Random weights from a ``torch.Generator`` seeded with ``seed``
        on ``device``."""
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        init = lm.init_lm if self._attn_lm else ssm_lm.init_ssm_lm
        return init(gen, self.cfg, self.dims, dtype)

    def init_serve_state(self, batch: int, cache_len: int,
                         cache_dtype=torch.bfloat16, device="cuda"):
        """``cache_dtype`` may be the string "int8" for dense and moe:
        the KV pool is then int8 with per-(token, head) f32 absmax scales
        (``serving.kv_quant``)."""
        if lm.is_int8(cache_dtype) and not self._attn_lm:
            raise ValueError(
                f"int8 cache needs an attention KV pool; family="
                f"{self.cfg.family!r} keeps SSM/conv state in float")
        init = lm.lm_init_cache if self._attn_lm else ssm_lm.ssm_init_state
        return init(self.cfg, self.dims, batch, cache_len, cache_dtype,
                    resolve_device(device))

    def prefill(self, params, batch, cache_len: int,
                cache_dtype=torch.bfloat16, attn_backend: str = "pallas"):
        """``attn_backend="pallas"`` runs the prompt through the kernels
        (flash-attention; the SSD scan for ssm/hybrid); ``"einsum"`` through
        the reference's dense paths."""
        prefill = lm.lm_prefill if self._attn_lm else ssm_lm.ssm_prefill
        return prefill(params, batch, self.cfg, self.dims,
                       cache_len=cache_len, cache_dtype=cache_dtype,
                       attn_backend=attn_backend)

    def prefill_chunk(self, params, state, tokens, offsets, lengths,
                      rows=None, attn_backend: str = "pallas"):
        """Advance a chunked prefill: run ``tokens`` (B, C) at per-row cache
        ``offsets`` (B,) against the carried serve state (the KV cache for
        dense; SSM, conv and attention state for ssm/hybrid), batch row b
        in state row ``rows[b]`` (default b), updated in place. Returns
        (last-real-token logits, state, pos (B,) = offset + length).
        Chunk by chunk equals the single-shot ``prefill``. moe raises, as
        in the reference: per-chunk routing would drop other tokens than
        single-shot."""
        if self.cfg.family == "moe":
            raise ValueError("chunked prefill unsupported for 'moe'")
        chunk = lm.lm_prefill_chunk if self._attn_lm \
            else ssm_lm.ssm_prefill_chunk
        return chunk(params, state, tokens, offsets, lengths, self.cfg,
                     self.dims, rows=rows, attn_backend=attn_backend)

    def decode(self, params, state, tokens, pos, attn_backend: str = "pallas",
               write_rows=None):
        """``attn_backend="pallas"`` decodes attention through the
        flash-decode kernel; ``"einsum"`` keeps the reference's dense path.
        ``write_rows`` limits the state write to those rows (see
        ``lm.lm_decode``, ``ssm_lm.ssm_decode``)."""
        decode = lm.lm_decode if self._attn_lm else ssm_lm.ssm_decode
        return decode(params, state, tokens, pos, self.cfg, self.dims,
                      attn_backend=attn_backend, write_rows=write_rows)


def make_model(cfg: ArchConfig, tp: int = 1) -> Model:
    return Model(cfg, padded_dims(cfg, tp))
