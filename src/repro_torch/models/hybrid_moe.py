"""The hybrid_moe family (IBM's granitemoehybrid, Granite 4.0-H): Mamba-2
mixers and GQA attention layers side by side, as ``cfg.layer_types`` lays
them out, each layer with its own weights and each followed by a dropless
top-k MoE FFN plus an always-on shared expert. The granite muP scalars
apply. Per layer, in the published config's own form:

    h += residual_multiplier * mixer(norm(h))
    h += residual_multiplier * (moe(norm(h)) + shared(norm(h)))

with the embedding times ``embedding_multiplier`` and the logits divided
by ``logits_scaling``. The attention has no position embedding where
``position_embedding_type`` is "nope" (RoPE at ``rope_theta`` otherwise)
and scales its scores by ``attention_multiplier`` (``ops.flash_attention``
/ ``ops.flash_decode`` take the scale). The Mamba-2 mixer is
``models.ssd``'s, the attention ``models.attention``'s, the expert layer
``models.moe``'s dropless one over the experts this device holds
(``cfg.experts_held`` of ``cfg.num_experts``; the router spans them all).

Parameters: ``embed``, ``final_norm``, ``lm_head`` unless tied, and
``layers``, one dict a layer: ``norm`` and ``mamba`` (a Mamba-2 mixer's
leaves) or ``attn`` (``wq``, ``wk``, ``wv``, ``wo``), then ``ffn_norm``
and ``moe`` (``moe.init_held_moe``'s leaves).

The serve state holds the two kinds side by side: ``ssm`` (Lm, B, H, P, N)
f32 and ``conv`` (Lm, B, W - 1, C) for the Lm Mamba layers, and
``attn_k`` / ``attn_v`` (La, B, S, G, hd) for the La attention layers
(the names the engine's ``SEQ_LEAVES`` and ``_write_state`` know). Prefill
takes per-row ``lengths`` (a bucket's pad positions are inert in the scan
and route to no expert) and decode honours ``write_rows``, as
``models.ssm_lm`` does. Chunked prefill, training and sharded state are
not ported for this family: ``hybrid_moe_forward`` raises, the engine
keeps it out of its chunked families, and a ``shard_fn`` raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import host_to_device
from repro_torch.models import attention as attn
from repro_torch.models.dims import PaddedDims
from repro_torch.models.layers import he_init, lookup, rms_norm
from repro_torch.models.lm import _logits, last_logits
from repro_torch.models.moe import (count_held_decode, held_moe_decode,
                                    held_moe_prefill, init_held_moe)
from repro_torch.models.ssd import (init_mamba2, mamba2_decode,
                                    mamba2_forward, mamba2_init_state)


def layer_slots(cfg: ArchConfig) -> list:
    """[(kind, index)] a layer: its kind and its row among the serve
    state's leaves of that kind (``ssm``/``conv`` or ``attn_k``/
    ``attn_v``)."""
    seen = {"mamba": 0, "attention": 0}
    out = []
    for kind in cfg.layer_types:
        if kind not in seen:
            raise ValueError(f"{cfg.name}: unknown layer type {kind!r}: "
                             "mamba or attention")
        out.append((kind, seen[kind]))
        seen[kind] += 1
    if len(out) != cfg.num_layers:
        raise ValueError(f"{cfg.name}: {len(out)} layer_types for "
                         f"{cfg.num_layers} layers")
    return out


# prompt tokens a prefill runs through the layers at a time (whole rows):
# bounds the activations of a large fleet prefill (64 rows at the 4,096
# bucket would otherwise hold several (262,144 x 16,768) projections)
PREFILL_TOKENS = 32768


def _rope(cfg: ArchConfig) -> float:
    return cfg.rope_theta if cfg.position_embedding_type == "rope" else 0.0


def _unsharded(shard_fn) -> None:
    if shard_fn is not None:
        raise NotImplementedError("hybrid_moe's serve state is not sharded "
                                  "in this port")


def init_hybrid_moe(gen: torch.Generator, cfg: ArchConfig, dims: PaddedDims,
                    dtype=torch.float32) -> dict:
    """Random weights from ``gen``, on ``gen``'s device."""
    dev = gen.device
    zeros = dict(dtype=torch.float32, device=dev)
    # the embedding enters the residual at 0.02 after its multiplier: at
    # 0.02 before it, each token's own row would dominate the tied head
    params = {
        "embed": (torch.randn((dims.vocab, cfg.d_model), generator=gen,
                              device=dev) * (0.02 / cfg.embedding_multiplier)
                  ).to(dtype),
        "final_norm": torch.zeros((cfg.d_model,), **zeros),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = he_init(gen, (cfg.d_model, dims.vocab), dtype,
                                    cfg.d_model)
    layers = []
    for kind, _ in layer_slots(cfg):
        lp = {"norm": torch.zeros((cfg.d_model,), **zeros)}
        if kind == "mamba":
            lp["mamba"] = init_mamba2(gen, cfg.d_model, cfg.d_inner,
                                      cfg.ssm_heads, cfg.ssm_head_dim,
                                      cfg.ssm_state, cfg.ssm_groups,
                                      cfg.ssm_conv_width, dtype)
        else:
            lp["attn"] = attn.init_attention(gen, cfg.d_model, dims,
                                             cfg.resolved_head_dim, False,
                                             dtype)
        lp["ffn_norm"] = torch.zeros((cfg.d_model,), **zeros)
        lp["moe"] = init_held_moe(gen, cfg.d_model, cfg.moe_d_ff, cfg.d_ff,
                                  cfg.num_experts, cfg.held_experts, dtype)
        layers.append(lp)
    params["layers"] = layers
    return params


def hybrid_moe_forward(params, batch, cfg, dims, **_):
    raise NotImplementedError(
        "hybrid_moe serves only (prefill and decode): its training forward "
        "is not ported")


def hybrid_moe_init_state(cfg, dims, batch: int, max_len: int,
                          dtype=torch.bfloat16, device="cuda") -> dict:
    if isinstance(dtype, str):
        raise ValueError(f"cache dtype {dtype!r} needs an attention KV pool; "
                         f"family={cfg.family!r} keeps its state in float")
    kinds = [k for k, _ in layer_slots(cfg)]
    st = mamba2_init_state(batch, cfg, dtype, device)
    state = {n: t.new_zeros((kinds.count("mamba"),) + tuple(t.shape))
             for n, t in st.items()}
    shape = (kinds.count("attention"), batch, max_len, dims.n_kv,
             cfg.resolved_head_dim)
    state["attn_k"] = torch.zeros(shape, dtype=dtype, device=device)
    state["attn_v"] = torch.zeros(shape, dtype=dtype, device=device)
    return state


def _embed(params, tokens, cfg):
    h = lookup(params["embed"], tokens)
    return h * cfg.embedding_multiplier if cfg.embedding_multiplier != 1 \
        else h


def hybrid_moe_prefill(params, batch, cfg: ArchConfig, dims: PaddedDims, *,
                       cache_len: int, cache_dtype=torch.bfloat16,
                       attn_backend: str = "pallas", shard_fn=None):
    """Prefill: returns (last-token logits, serve state, pos (B,) int32).
    ``batch["lengths"]`` (B,) marks right-padded bucketed prompts: pad
    steps are inert in the scans (dt = 0), causal attention masks them,
    they route to no expert, and logits come from ``lengths - 1``.
    ``attn_backend="pallas"`` scans through ``ops.ssd_scan`` and attends
    through ``ops.flash_attention``; ``"einsum"`` runs the dense paths.
    Rows go through the layers ``PREFILL_TOKENS`` prompt tokens at a time
    (at least one row), each group writing its rows of the state.

    ``batch["host_lengths"]`` (m,), the first m rows' lengths on the host
    (an engine's bucketed admission passes them), lets each of those rows
    run at its own length (``fit_len``) instead of the bucket's, rows of
    one fitted length together: a bucket's cost then follows its prompts,
    whatever else shares it. Rows m.. are the bucket's pad rows, whose
    outputs nobody reads: they compute nothing (zero logits and state)."""
    _unsharded(shard_fn)
    tokens = batch["tokens"]
    lengths = batch.get("lengths")
    host = batch.get("host_lengths")
    B, S = tokens.shape
    state = hybrid_moe_init_state(cfg, dims, B, cache_len, cache_dtype,
                                  tokens.device)
    if host is None or lengths is None:
        logits, pos = _prefill_group(params, tokens, lengths, state, cfg,
                                     dims, attn_backend)
        return logits / cfg.logits_scaling, state, pos
    groups: dict = {}
    for r, n in enumerate(host):
        groups.setdefault(fit_len(int(n), S, cfg.ssm_chunk), []).append(r)
    logits = None
    for L, rows in sorted(groups.items()):
        idx = host_to_device(np.asarray(rows, np.int64), tokens.device)
        sub = hybrid_moe_init_state(cfg, dims, len(rows), L, cache_dtype,
                                    tokens.device)
        lg, _ = _prefill_group(params, tokens[idx, :L], lengths[idx], sub,
                               cfg, dims, attn_backend)
        if logits is None:
            logits = lg.new_zeros((B,) + tuple(lg.shape[1:]))
        logits[idx] = lg
        for n, t in sub.items():
            if n in ("attn_k", "attn_v"):
                state[n][:, idx, :L] = t
            else:
                state[n][:, idx] = t
    return logits / cfg.logits_scaling, state, lengths.to(torch.int32)


def fit_len(n: int, bucket: int, chunk: int) -> int:
    """The length a row of ``n`` prompt tokens runs at inside a prefill
    bucket of ``bucket``: its power of two up to the SSD scan's ``chunk``
    (at least 8), past that a multiple of the chunk (the scan takes a
    length that is a multiple of min(chunk, length)), never past the
    bucket."""
    fit = 8
    while fit < min(n, chunk):
        fit *= 2
    if n > chunk:
        fit = -(-n // chunk) * chunk
    return min(fit, bucket)


def _prefill_group(params, tokens, lengths, state, cfg, dims, attn_backend):
    """Rows through the layers ``PREFILL_TOKENS`` prompt tokens at a time,
    each step writing its rows of ``state`` in place: (logits, pos)."""
    B, S = tokens.shape
    step = max(1, PREFILL_TOKENS // S)
    outs = [_prefill_rows(params, tokens[r:r + step],
                          None if lengths is None else lengths[r:r + step],
                          {n: t[:, r:r + step] for n, t in state.items()},
                          cfg, dims, attn_backend)
            for r in range(0, B, step)]
    return tuple(torch.cat(x) for x in zip(*outs))


def _prefill_rows(params, tokens, lengths, state, cfg, dims, attn_backend):
    """``hybrid_moe_prefill`` over one group of rows, writing their rows of
    the serve state (``state``: views of them) in place: (logits, pos)."""
    S = tokens.shape[1]
    h = _embed(params, tokens, cfg)
    valid = None if lengths is None else \
        torch.arange(S, device=h.device)[None, :] < lengths[:, None]
    rm = cfg.residual_multiplier
    for (kind, i), lp in zip(layer_slots(cfg), params["layers"]):
        x = rms_norm(h, lp["norm"], cfg.norm_eps)
        if kind == "mamba":
            y, st = mamba2_forward(lp["mamba"], x, cfg, return_state=True,
                                   lengths=lengths, attn_backend=attn_backend)
            state["ssm"][i].copy_(st["ssm"])
            state["conv"][i].copy_(st["conv"])
        else:
            y = attn.prefill_attention(lp["attn"], x, dims,
                                       state["attn_k"][i], state["attn_v"][i],
                                       rope_theta=_rope(cfg),
                                       backend=attn_backend,
                                       scale=cfg.softmax_scale)
        h = h + y * rm
        x = rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
        h = h + held_moe_prefill(lp["moe"], x,
                                 top_k=cfg.num_experts_per_tok,
                                 valid=valid) * rm
    return last_logits(params, h, cfg, lengths)


def hybrid_moe_decode(params, state, tokens, pos, cfg: ArchConfig,
                      dims: PaddedDims, *, attn_backend: str = "pallas",
                      write_rows=None, shard_fn=None):
    """One decode step. tokens: (B, 1) int; pos: (B,) int32, each row's
    cache write index (the attention layers'). Updates ``state`` in place
    -- only rows ``write_rows`` (an int index tensor) when given: the
    fleet's non-stepping rows keep their SSM, conv and KV state bit for
    bit -- and returns (logits (B, V), state). No host sync: a CUDA graph
    captures it."""
    _unsharded(shard_fn)
    h = _embed(params, tokens, cfg)                                # (B, 1, d)
    rm = cfg.residual_multiplier
    picks = []
    for (kind, i), lp in zip(layer_slots(cfg), params["layers"]):
        x = rms_norm(h, lp["norm"], cfg.norm_eps)
        if kind == "mamba":
            y, _ = mamba2_decode(lp["mamba"], x, cfg,
                                 {"ssm": state["ssm"][i],
                                  "conv": state["conv"][i]}, rows=write_rows,
                                 attn_backend=attn_backend)
        else:
            q, k_new, v_new = attn.project_decode_qkv(lp["attn"], x, dims,
                                                      pos, _rope(cfg))
            kc, vc = attn.write_kv(state["attn_k"][i], state["attn_v"][i],
                                   k_new, v_new, pos, write_rows)
            y = attn.decode_attend(lp["attn"], q, kc, vc, pos, dims,
                                   backend=attn_backend,
                                   scale=cfg.softmax_scale)
        h = h + y * rm
        x = rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
        y, top_i = held_moe_decode(lp["moe"], x,
                                   top_k=cfg.num_experts_per_tok)
        picks.append(top_i)
        h = h + y * rm
    count_held_decode(picks, cfg.held_experts, write_rows)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _logits(params, h)[:, 0] / cfg.logits_scaling, state
