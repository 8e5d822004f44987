"""Decoder-only LM, dense family (the port of ``repro.models.lm``'s dense
path).

Parameters are a plain dict: ``embed`` (V, d), ``final_norm`` (d,),
``lm_head`` (d, V) unless embeddings are tied, and ``layers``, a list with
one dict per layer (``attn_norm``, ``attn``, ``ffn_norm``, ``mlp``) -- the
reference stacks the same leaves along a leading layer axis for
``lax.scan``; ``repro_torch.bridge`` maps one onto the other.

The KV cache is a dict of two (L, B, S, G, hd) tensors. Prefill and decode
write it in place, one layer view at a time (the reference updates it
functionally and relies on jit buffer donation; eagerly that would copy
every layer each step).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.dims import PaddedDims
from repro_torch.models.layers import gelu, he_init, rms_norm, silu


def init_mlp(gen, d_model, d_ff, activation, dtype) -> dict:
    p = {"w_gate": he_init(gen, (d_model, d_ff), dtype, d_model),
         "w_down": he_init(gen, (d_ff, d_model), dtype, d_ff)}
    if activation == "swiglu":
        p["w_up"] = he_init(gen, (d_model, d_ff), dtype, d_model)
    return p


def mlp_apply(p, x, activation):
    g = x @ p["w_gate"]
    h = silu(g) * (x @ p["w_up"]) if activation == "swiglu" else gelu(g)
    return h @ p["w_down"]


def _init_layer(gen, cfg: ArchConfig, dims: PaddedDims, dtype) -> dict:
    zeros = dict(dtype=torch.float32, device=gen.device)
    return {
        "attn_norm": torch.zeros((cfg.d_model,), **zeros),
        "attn": attn.init_attention(gen, cfg.d_model, dims,
                                    cfg.resolved_head_dim, cfg.qkv_bias,
                                    dtype),
        "ffn_norm": torch.zeros((cfg.d_model,), **zeros),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation, dtype),
    }


def init_lm(gen: torch.Generator, cfg: ArchConfig, dims: PaddedDims,
            dtype=torch.float32) -> dict:
    """Random weights from ``gen``, on ``gen``'s device."""
    dev = gen.device
    params = {
        "embed": (torch.randn((dims.vocab, cfg.d_model), generator=gen,
                              device=dev) * 0.02).to(dtype),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                  device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = he_init(gen, (cfg.d_model, dims.vocab), dtype,
                                    cfg.d_model)
    params["layers"] = [_init_layer(gen, cfg, dims, dtype)
                        for _ in range(cfg.num_layers)]
    return params


def _ffn_sublayer(lp, h, cfg):
    x = rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
    return h + mlp_apply(lp["mlp"], x, cfg.activation)


def block_prefill(lp, h, cfg, dims, k_cache, v_cache, attn_backend):
    """One attention + MLP block over a prompt (a dense layer, or the
    hybrid family's shared block), writing its K/V into the per-layer
    caches (B, S_cache, G, hd) in place."""
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    h = h + attn.prefill_attention(lp["attn"], x, dims, k_cache, v_cache,
                                   rope_theta=cfg.rope_theta,
                                   backend=attn_backend)
    return _ffn_sublayer(lp, h, cfg)


def block_decode(lp, h, cfg, dims, k_cache, v_cache, pos, attn_backend,
                 write_rows=None):
    """One attention + MLP block for one token per row, writing its K/V at
    ``pos`` into the per-layer caches in place (rows ``write_rows`` only,
    when given)."""
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    q, k_new, v_new = attn.project_decode_qkv(lp["attn"], x, dims, pos,
                                              cfg.rope_theta)
    kc, vc = attn.write_kv(k_cache, v_cache, k_new, v_new, pos, write_rows)
    h = h + attn.decode_attend(lp["attn"], q, kc, vc, pos, dims,
                               backend=attn_backend)
    return _ffn_sublayer(lp, h, cfg)


def _logits(params, h):
    head = params.get("lm_head")
    return h @ head if head is not None else h @ params["embed"].T


def last_logits(params, h, cfg, lengths):
    """Final norm and head at each row's last real position of a prompt
    (``lengths`` (B,), or the last column when None). Returns (logits,
    pos (B,) int32, each row's next cache index)."""
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    B, S = h.shape[:2]
    if lengths is None:
        last = h[:, -1]
        pos = torch.full((B,), S, dtype=torch.int32, device=h.device)
    else:
        last = h[torch.arange(B, device=h.device), (lengths - 1).long()]
        pos = lengths.to(torch.int32)
    return _logits(params, last), pos


# ---------------------------------------------------------------- serve path
def lm_init_cache(cfg, dims, batch: int, max_len: int, dtype=torch.bfloat16,
                  device="cuda") -> dict:
    if isinstance(dtype, str):
        raise NotImplementedError(f"cache dtype {dtype!r} (the int8 KV "
                                  "codec) is not yet ported")
    shape = (cfg.num_layers, batch, max_len, dims.n_kv,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def lm_decode(params, cache, tokens, pos, cfg: ArchConfig, dims: PaddedDims,
              *, attn_backend: str = "pallas", write_rows=None):
    """One decode step. tokens: (B,1) int; pos: (B,) int32 tensor -- the
    cache write index of each row. Writes the new K/V into ``cache`` in
    place (only rows ``write_rows``, an int index tensor, when given: the
    fleet's non-stepping rows keep their cache) and returns
    (logits (B, V), cache)."""
    h = params["embed"][tokens]                              # (B,1,d)
    for li, lp in enumerate(params["layers"]):
        h = block_decode(lp, h, cfg, dims, cache["k"][li], cache["v"][li],
                         pos, attn_backend, write_rows)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _logits(params, h)[:, 0], cache


def lm_prefill(params, batch, cfg, dims, *, cache_len: int,
               cache_dtype=torch.bfloat16, attn_backend: str = "pallas"):
    """Prefill: full forward + cache fill. Returns (last-token logits, cache,
    pos (B,) int32).

    ``batch["lengths"]`` (B,) marks the true prompt length per row when the
    token matrix is right-padded to a bucket length: logits are gathered at
    ``lengths-1`` and ``pos`` is ``lengths``. Causal masking keeps real
    positions exact under trailing pads; pad K/V beyond ``pos`` is masked by
    the decode path until overwritten."""
    tokens = batch["tokens"]
    B = tokens.shape[0]
    h = params["embed"][tokens]
    cache = lm_init_cache(cfg, dims, B, cache_len, cache_dtype,
                          device=h.device)
    for li, lp in enumerate(params["layers"]):
        h = block_prefill(lp, h, cfg, dims, cache["k"][li], cache["v"][li],
                          attn_backend)
    logits, pos = last_logits(params, h, cfg, batch.get("lengths"))
    return logits, cache, pos
