"""Model facade: one API over the ported architecture families (the port of
``repro.models.model``'s serving half).

    model = make_model(get_config("granite-3-8b"))
    params = model.init(seed=0, dtype=torch.bfloat16, device="cuda")
    logits, state, pos = model.prefill(params, batch, cache_len=1024)
    logits, state = model.decode(params, state, tokens, pos)

Only the dense family is ported; the others raise ``ValueError``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.dims import PaddedDims, padded_dims

PORTED_FAMILIES = ("dense",)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    dims: PaddedDims

    def __post_init__(self):
        if self.cfg.family not in PORTED_FAMILIES:
            raise ValueError(f"family {self.cfg.family!r} "
                             f"({self.cfg.name}) is not yet ported")

    def init(self, seed: int = 0, dtype=torch.float32, device="cuda"):
        """Random weights from a ``torch.Generator`` seeded with ``seed``
        on ``device``."""
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        return lm.init_lm(gen, self.cfg, self.dims, dtype)

    def init_serve_state(self, batch: int, cache_len: int,
                         cache_dtype=torch.bfloat16, device="cuda"):
        return lm.lm_init_cache(self.cfg, self.dims, batch, cache_len,
                                cache_dtype, resolve_device(device))

    def prefill(self, params, batch, cache_len: int,
                cache_dtype=torch.bfloat16, attn_backend: str = "kernel"):
        return lm.lm_prefill(params, batch, self.cfg, self.dims,
                             cache_len=cache_len, cache_dtype=cache_dtype,
                             attn_backend=attn_backend)

    def decode(self, params, state, tokens, pos, attn_backend: str = "kernel",
               write_rows=None):
        """``attn_backend="kernel"`` decodes through the flash-decode kernel;
        ``"einsum"`` keeps the reference's dense path. ``write_rows`` limits
        the cache write to those rows (see ``lm.lm_decode``)."""
        return lm.lm_decode(params, state, tokens, pos, self.cfg, self.dims,
                            attn_backend=attn_backend, write_rows=write_rows)


def make_model(cfg: ArchConfig, tp: int = 1) -> Model:
    return Model(cfg, padded_dims(cfg, tp))
