"""Model facade: one API over the ported architecture families (the port of
``repro.models.model``'s serving half).

    model = make_model(get_config("granite-3-8b"))
    params = model.init(seed=0, dtype=torch.bfloat16, device="cuda")
    logits, state, pos = model.prefill(params, batch, cache_len=1024)
    logits, state = model.decode(params, state, tokens, pos)
    logits, state, pos = model.prefill_chunk(params, state, tokens,
                                             offsets, lengths)

Every family of the reference is ported: dense, moe and vlm through
``models.lm`` (a vlm batch carries ``patch_embeds``), ssm and hybrid
through ``models.ssm_lm``, audio through ``models.encdec`` (a batch
carries ``frame_embeds``); an unknown family raises ``ValueError``.
``cache_dtype="int8"`` (the quantized KV codec of ``serving.kv_quant``) is
taken by the attention-LM families (dense, moe, vlm) only, and chunked
prefill is refused for moe (expert capacity would scale with the chunk,
not the prompt) and for vlm and audio (their requests carry per-request
extras and stay on exact-length single admits), as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, lm, ssm_lm
from repro_torch.models.dims import PaddedDims, padded_dims


class _Serves(NamedTuple):
    """The module that serves a family and its four entry points."""
    module: object
    init: Callable
    init_state: Callable
    prefill: Callable
    decode: Callable


_LM = _Serves(lm, lm.init_lm, lm.lm_init_cache, lm.lm_prefill, lm.lm_decode)
_SSM = _Serves(ssm_lm, ssm_lm.init_ssm_lm, ssm_lm.ssm_init_state,
               ssm_lm.ssm_prefill, ssm_lm.ssm_decode)
_ENCDEC = _Serves(encdec, encdec.init_encdec, encdec.encdec_init_state,
                  encdec.encdec_prefill, encdec.encdec_decode)
SERVES = {"dense": _LM, "moe": _LM, "ssm": _SSM, "hybrid": _SSM,
          "vlm": _LM, "audio": _ENCDEC}
PORTED_FAMILIES = tuple(SERVES)
# serve-state leaves with a sequence axis (axis 2, after the layer and row
# axes: the attention caches, float or int8 with their scales, the
# decoder's self cache); the others (SSM and conv state, the encoder's
# cross K/V over its fixed Le positions) are written whole
SEQ_LEAVES = ("k", "v", "attn_k", "attn_v", "k_q", "v_q", "k_s", "v_s",
              "self_k", "self_v")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    dims: PaddedDims

    def __post_init__(self):
        if self.cfg.family not in PORTED_FAMILIES:
            raise ValueError(f"family {self.cfg.family!r} "
                             f"({self.cfg.name}) is not yet ported")

    @property
    def _serves(self) -> _Serves:
        """This family's entry points: ``lm`` (dense, moe, vlm), ``ssm_lm``
        (ssm, hybrid) or ``encdec`` (audio)."""
        return SERVES[self.cfg.family]

    def init(self, seed: int = 0, dtype=torch.float32, device="cuda"):
        """Random weights from a ``torch.Generator`` seeded with ``seed``
        on ``device``."""
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        return self._serves.init(gen, self.cfg, self.dims, dtype)

    def init_serve_state(self, batch: int, cache_len: int,
                         cache_dtype=torch.bfloat16, device="cuda"):
        """``cache_dtype`` may be the string "int8" for dense, moe and vlm:
        the KV pool is then int8 with per-(token, head) f32 absmax scales
        (``serving.kv_quant``). A vlm pool holds ``cache_len`` +
        ``num_patches`` positions a row."""
        if lm.is_int8(cache_dtype) and self._serves.module is not lm:
            raise ValueError(
                f"int8 cache needs an attention KV pool; family="
                f"{self.cfg.family!r} keeps its state in float")
        return self._serves.init_state(self.cfg, self.dims, batch,
                                       cache_len, cache_dtype,
                                       resolve_device(device))

    def prefill(self, params, batch, cache_len: int,
                cache_dtype=torch.bfloat16, attn_backend: str = "pallas"):
        """``attn_backend="pallas"`` runs the prompt through the kernels
        (flash-attention; the SSD scan for ssm/hybrid); ``"einsum"`` through
        the reference's dense paths. A vlm batch carries ``patch_embeds``
        (B, P, d), an audio batch ``frame_embeds`` (B, Le, d)."""
        return self._serves.prefill(params, batch, self.cfg, self.dims,
                                    cache_len=cache_len,
                                    cache_dtype=cache_dtype,
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
        single-shot; vlm and audio raise, as in the reference: their
        requests carry per-request extras."""
        if self.cfg.family in ("moe", "vlm", "audio"):
            raise ValueError(
                f"chunked prefill unsupported for {self.cfg.family!r}")
        chunk = lm.lm_prefill_chunk if self._serves.module is lm \
            else ssm_lm.ssm_prefill_chunk
        return chunk(params, state, tokens, offsets, lengths, self.cfg,
                     self.dims, rows=rows, attn_backend=attn_backend)

    def decode(self, params, state, tokens, pos, attn_backend: str = "pallas",
               write_rows=None):
        """``attn_backend="pallas"`` decodes attention through the
        flash-decode kernel; ``"einsum"`` keeps the reference's dense path.
        ``write_rows`` limits the state write to those rows (see
        ``lm.lm_decode``, ``ssm_lm.ssm_decode``)."""
        return self._serves.decode(params, state, tokens, pos, self.cfg,
                                   self.dims, attn_backend=attn_backend,
                                   write_rows=write_rows)


def make_model(cfg: ArchConfig, tp: int = 1) -> Model:
    return Model(cfg, padded_dims(cfg, tp))
