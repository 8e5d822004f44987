"""Decoder-only LM, the dense, moe and vlm families (the port of
``repro.models.lm``): the training forward ``lm_forward`` and the serve
path.

Parameters are a plain dict: ``embed`` (V, d), ``final_norm`` (d,),
``lm_head`` (d, V) unless embeddings are tied, and ``layers``, a list with
one dict per layer (``attn_norm``, ``attn``, ``ffn_norm``, and ``mlp`` or,
on an MoE layer, ``moe``) -- the reference stacks the same leaves along a
leading layer axis for ``lax.scan``; ``repro_torch.bridge`` maps one onto
the other. Layer i is an MoE layer iff the config uses MoE and i is a
multiple of ``moe_every``: the reference's layer groups (one MoE layer,
then ``moe_every - 1`` dense ones) in order, flattened. A vlm model has
``patch_proj`` (d, d) too: a request's ``patch_embeds`` (B, P, d), times
it, are prepended to its tokens, so the prompt is P + L positions, RoPE
runs over 0 .. P + L - 1, the cache holds ``num_patches`` more positions
than it is asked for, and every ``pos`` counts the prefix.

The KV cache is a dict of two (L, B, S, G, hd) tensors, ``k`` and ``v``,
or with ``cache_dtype="int8"`` the quantized pool of
``serving.kv_quant``: ``k_q`` / ``v_q`` int8 (L, B, S, G, hd) and their
f32 scales ``k_s`` / ``v_s`` (L, B, S, G). Prefill and decode write it in
place, one layer view at a time (the reference updates it functionally
and relies on jit buffer donation; eagerly that would copy every layer
each step). An int8 prefill runs in f32 and quantizes the filled cache
once at the end; a decode quantizes each new token on write. A chunked
prefill (``lm_prefill_chunk``) continues a float cache one chunk at a
time.

The training forward attends through the einsum path: the attention
kernels have no backward (``kernels.ops``), and neither has the
reference's Pallas path. ``remat`` (``remat_policy``) recomputes each
layer's activations in the backward: ``"full"`` keeps only its input,
``"dots"`` also the outputs of its 2-D matmuls (the counterpart of the
reference's ``dots_with_no_batch_dims_saveable``).
"""
from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.dims import PaddedDims
from repro_torch.models.layers import (fresh_state, gelu, he_init, lookup,
                                       per_shard, rms_norm, silu)
from repro_torch.models.moe import init_moe, moe_apply
from repro_torch.serving import kv_quant


def init_mlp(gen, d_model, d_ff, activation, dtype) -> dict:
    p = {"w_gate": he_init(gen, (d_model, d_ff), dtype, d_model),
         "w_down": he_init(gen, (d_ff, d_model), dtype, d_ff)}
    if activation == "swiglu":
        p["w_up"] = he_init(gen, (d_model, d_ff), dtype, d_model)
    return p


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS \
        else ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(fn, *args, **kwargs):
    return ckpt.checkpoint(fn, *args, use_reentrant=False, **kwargs)


def remat_policy(name: str):
    """``apply(fn, *args)``, which calls ``fn(*args)`` with the activation
    recomputation ``name`` names: ``"none"`` (keep them), ``"full"``
    (recompute all in the backward) or ``"dots"`` (keep the 2-D matmuls'
    outputs, recompute the rest). Values are the same under each; only the
    memory differs. Unknown names raise ``ValueError``."""
    if name == "none":
        return lambda fn, *args: fn(*args)
    if name == "full":
        return _checkpointed
    if name == "dots":
        return functools.partial(
            _checkpointed, context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"unknown remat policy {name!r}: none, full or dots")


def mlp_apply(p, x, activation):
    g = x @ p["w_gate"]
    h = silu(g) * (x @ p["w_up"]) if activation == "swiglu" else gelu(g)
    return h @ p["w_down"]


def n_layers(cfg: ArchConfig) -> int:
    """Layers the model runs: the reference builds whole groups of
    ``moe_every`` layers only."""
    me = cfg.moe_every if cfg.uses_moe else 1
    return cfg.num_layers // me * me


def _init_layer(gen, cfg: ArchConfig, dims: PaddedDims, dtype,
                is_moe: bool) -> dict:
    zeros = dict(dtype=torch.float32, device=gen.device)
    p = {
        "attn_norm": torch.zeros((cfg.d_model,), **zeros),
        "attn": attn.init_attention(gen, cfg.d_model, dims,
                                    cfg.resolved_head_dim, cfg.qkv_bias,
                                    dtype),
        "ffn_norm": torch.zeros((cfg.d_model,), **zeros),
    }
    if is_moe:
        p["moe"] = init_moe(gen, cfg.d_model, cfg.moe_d_ff or cfg.d_ff,
                            cfg.num_experts, dtype, cfg.moe_shared_expert,
                            cfg.activation)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                            dtype)
    return p


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
    params["layers"] = [_init_layer(gen, cfg, dims, dtype,
                                    cfg.uses_moe and i % cfg.moe_every == 0)
                        for i in range(n_layers(cfg))]
    if cfg.family == "vlm":
        params["patch_proj"] = he_init(gen, (cfg.d_model, cfg.d_model), dtype,
                                       cfg.d_model)
    return params


def embed_inputs(params, cfg, batch):
    """Token embeddings, after the projected patch prefix for vlm. Returns
    (h (B, S_total, d), text_start: the prefix length, 0 without one)."""
    h = lookup(params["embed"], batch["tokens"])                     # (B, L, d)
    if cfg.family != "vlm":
        return h, 0
    patches = batch["patch_embeds"].to(h.dtype) @ params["patch_proj"]
    return torch.cat([patches, h], dim=1), cfg.num_patches


def _ffn_sublayer(lp, h, cfg, shard_fn=None):
    """The FFN half of a block: the dense MLP, or on an MoE layer the
    routed experts. Returns (h, aux): the experts' Switch load-balance
    loss, None on a dense layer (serving drops it)."""
    x = rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
    if "moe" in lp:
        y, aux = moe_apply(lp["moe"], x, num_experts=cfg.num_experts,
                           top_k=cfg.num_experts_per_tok,
                           capacity_factor=cfg.capacity_factor,
                           activation=cfg.activation, shard_fn=shard_fn)
        return h + y, aux
    return h + mlp_apply(lp["mlp"], x, cfg.activation), None


def train_block(lp, h, cfg, dims, positions, shard_fn=None):
    """One attention + FFN block over a whole sequence, einsum attention
    (a dense or MoE layer, or the hybrid family's shared block). Returns
    (h, aux or None)."""
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    h = h + attn.attention(lp["attn"], x, dims, positions=positions,
                           rope_theta=cfg.rope_theta, causal=True,
                           backend="einsum", shard_fn=shard_fn)
    return _ffn_sublayer(lp, h, cfg, shard_fn)


def lm_forward(params, batch, cfg: ArchConfig, dims: PaddedDims, *,
               remat: str = "none", shard_fn=None,
               return_features: bool = False):
    """Full-sequence training forward. Returns (logits (B, S_total, V),
    aux) -- or (features (B, S_total, d), aux) with ``return_features``
    (the chunked CE applies the head itself, so the (T, V) logits are
    never held whole). ``aux`` (f32 scalar) sums the Switch loss of every
    MoE layer; a vlm batch's patch prefix counts in S_total. ``shard_fn``
    places the activations ("act_btd" after the embedding and each layer,
    "qkv"/"kv", "moe_buf", "logits"; ``distributed.sharding``)."""
    run = remat_policy(remat)
    h, _ = embed_inputs(params, cfg, batch)
    if shard_fn is not None:
        h = shard_fn(h, "act_btd")
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for lp in params["layers"]:
        h, a = run(train_block, lp, h, cfg, dims, positions, shard_fn)
        if shard_fn is not None:
            h = shard_fn(h, "act_btd")
        if a is not None:
            aux = aux + a
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if return_features:
        return h, aux
    logits = _logits(params, h)
    if shard_fn is not None:
        logits = shard_fn(logits, "logits")
    return logits, aux


def block_prefill(lp, h, cfg, dims, k_cache, v_cache, attn_backend,
                  shard_fn=None):
    """One attention + MLP block over a prompt (a dense layer, or the
    hybrid family's shared block), writing its K/V into the per-layer
    caches (B, S_cache, G, hd) in place."""
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    h = h + attn.prefill_attention(lp["attn"], x, dims, k_cache, v_cache,
                                   rope_theta=cfg.rope_theta,
                                   backend=attn_backend)
    h = _ffn_sublayer(lp, h, cfg, shard_fn)[0]
    return h if shard_fn is None else shard_fn(h, "act_btd")


def block_chunk(lp, h, cfg, dims, k_cache, v_cache, positions, lengths,
                rows, attn_backend, shard_fn=None):
    """One attention + MLP block over a prefill chunk at its cache
    positions (``attention.chunk_prefill_attention``), writing its K/V
    into rows ``rows`` of the per-layer caches in place."""
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    h = h + attn.chunk_prefill_attention(lp["attn"], x, dims, k_cache,
                                         v_cache, positions, lengths,
                                         rope_theta=cfg.rope_theta,
                                         backend=attn_backend, rows=rows)
    h = _ffn_sublayer(lp, h, cfg, shard_fn)[0]
    return h if shard_fn is None else shard_fn(h, "act_btd")


def block_decode(lp, h, cfg, dims, lc: dict, pos, attn_backend,
                 write_rows=None, shard_fn=None):
    """One attention + MLP block for one token per row, writing its K/V at
    ``pos`` into the per-layer cache views ``lc`` (``k``/``v``, or the int8
    leaves ``k_q``/``v_q``/``k_s``/``v_s``) in place (rows ``write_rows``
    only, when given)."""
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    q, k_new, v_new = attn.project_decode_qkv(lp["attn"], x, dims, pos,
                                              cfg.rope_theta)
    if "k_q" in lc:
        quant = tuple(lc[n] for n in ("k_q", "v_q", "k_s", "v_s"))
        rows = () if write_rows is None else (write_rows,)
        per_shard(_write_quant, quant + (k_new, v_new, pos) + rows, (0, 2),
                  out_axes=[], blocks_only=True)
        y = attn.decode_attend(lp["attn"], q, lc["k_q"], lc["v_q"], pos,
                               dims, backend=attn_backend,
                               k_scale=lc["k_s"], v_scale=lc["v_s"])
    else:
        kc, vc = attn.write_kv(lc["k"], lc["v"], k_new, v_new, pos,
                               write_rows)
        y = attn.decode_attend(lp["attn"], q, kc, vc, pos, dims,
                               backend=attn_backend)
    return _ffn_sublayer(lp, h + y, cfg, shard_fn)[0]


def _write_quant(k_q, v_q, k_s, v_s, k_new, v_new, pos, rows=None):
    """``kv_quant.write_kv_quant`` over the int8 leaves given one by one
    (``per_shard`` passes tensors)."""
    kv_quant.write_kv_quant({"k_q": k_q, "v_q": v_q, "k_s": k_s,
                             "v_s": v_s}, k_new, v_new, pos, rows)


def _logits(params, h):
    head = params.get("lm_head")
    return h @ head if head is not None else h @ params["embed"].T


def last_logits(params, h, cfg, lengths, text_start: int = 0):
    """Final norm and head at each row's last real position of a prompt
    (``lengths`` (B,) real tokens after a prefix of ``text_start``
    positions, or the last column when None). Returns (logits, pos (B,)
    int32, each row's next cache index)."""
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    B, S = h.shape[:2]
    if lengths is None:
        last = h[:, -1]
        pos = torch.full((B,), S, dtype=torch.int32, device=h.device)
    else:
        idx = (text_start + lengths - 1).long()
        last = h[torch.arange(B, device=h.device), idx]
        pos = (text_start + lengths).to(torch.int32)
    return _logits(params, last), pos


# ---------------------------------------------------------------- serve path
def is_int8(dtype) -> bool:
    """The string "int8" selects the quantized KV codec (see the module
    docstring)."""
    return isinstance(dtype, str) and dtype == "int8"


def lm_init_cache(cfg, dims, batch: int, max_len: int, dtype=torch.bfloat16,
                  device="cuda") -> dict:
    """The KV pool of ``max_len`` positions a row (+ ``num_patches`` for
    vlm: the prefix lives in the cache too)."""
    if cfg.family == "vlm":
        max_len = max_len + cfg.num_patches
    shape = (cfg.num_layers, batch, max_len, dims.n_kv,
             cfg.resolved_head_dim)
    if is_int8(dtype):
        return {"k_q": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_q": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_s": torch.ones(shape[:-1], device=device),
                "v_s": torch.ones(shape[:-1], device=device)}
    if isinstance(dtype, str):
        raise ValueError(f"unknown cache dtype {dtype!r}")
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def lm_decode(params, cache, tokens, pos, cfg: ArchConfig, dims: PaddedDims,
              *, attn_backend: str = "pallas", write_rows=None,
              shard_fn=None):
    """One decode step. tokens: (B,1) int; pos: (B,) int32 tensor -- the
    cache write index of each row. Writes the new K/V into ``cache`` in
    place (only rows ``write_rows``, an int index tensor, when given: the
    fleet's non-stepping rows keep their cache) and returns
    (logits (B, V), cache)."""
    h = lookup(params["embed"], tokens)                              # (B,1,d)
    for li, lp in enumerate(params["layers"]):
        h = block_decode(lp, h, cfg, dims,
                         {n: t[li] for n, t in cache.items()}, pos,
                         attn_backend, write_rows, shard_fn)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _logits(params, h)[:, 0], cache


def lm_prefill(params, batch, cfg, dims, *, cache_len: int,
               cache_dtype=torch.bfloat16, attn_backend: str = "pallas",
               shard_fn=None):
    """Prefill: full forward + cache fill. Returns (last-token logits, cache,
    pos (B,) int32). A vlm batch carries ``patch_embeds`` (B, P, d): the
    prefix runs first, causal attention covers all P + L positions, and
    ``pos`` counts it.

    ``batch["lengths"]`` (B,) marks the true prompt length per row when the
    token matrix is right-padded to a bucket length: logits are gathered at
    ``lengths-1`` (after the prefix) and ``pos`` is ``lengths`` (+ P).
    Causal masking keeps real positions exact under trailing pads; pad K/V
    beyond ``pos`` is masked by the decode path until overwritten. ``cache_dtype="int8"`` runs the
    forward with an f32 cache and quantizes it once at the end, as the
    reference does (prefill is compute-bound; only decode needs the int8
    stream)."""
    h, text_start = embed_inputs(params, cfg, batch)
    B = h.shape[0]
    quant = is_int8(cache_dtype)
    cache = fresh_state(lm_init_cache, h, shard_fn, cfg, dims, B,
                        cache_len, torch.float32 if quant else cache_dtype)
    for li, lp in enumerate(params["layers"]):
        h = block_prefill(lp, h, cfg, dims, cache["k"][li], cache["v"][li],
                          attn_backend, shard_fn)
    logits, pos = last_logits(params, h, cfg, batch.get("lengths"),
                              text_start)
    if quant:
        kq, ks = kv_quant.quantize(cache.pop("k"))
        vq, vs = kv_quant.quantize(cache.pop("v"))
        cache = {"k_q": kq, "v_q": vq, "k_s": ks, "v_s": vs}
    return logits, cache, pos


def chunk_logits(params, h, cfg, offsets, lengths):
    """Final norm and head at each row's last real chunk position; returns
    (logits, pos (B,) int32 = offset + length, each row's next cache
    index)."""
    logits, _ = last_logits(params, h, cfg, lengths)
    return logits, (offsets + lengths).to(torch.int32)


def chunk_positions(offsets, C: int):
    """(B, C) int32 absolute cache positions of a chunk: offset + j."""
    return offsets[:, None].to(torch.int32) + torch.arange(
        C, dtype=torch.int32, device=offsets.device)[None, :]


def lm_prefill_chunk(params, cache, tokens, offsets, lengths, cfg, dims, *,
                     rows=None, attn_backend: str = "pallas", shard_fn=None):
    """Continue a prefill: run ``tokens`` (B, C) at per-row cache
    ``offsets`` (B,) against the float KV cache (leaves (L, R, S, G, hd)),
    row b in cache row ``rows[b]`` (default b), writing the chunk's K/V at
    [offset, offset + length) in place and attending causally over the
    whole prefix. ``lengths`` (B,) is each row's true token count within
    the chunk (rows are right-padded to the fixed chunk width). Returns
    (last-real-token logits (B, V), cache, pos (B,) = offset + length).
    Chunk-by-chunk equals single-shot prefill: causal attention decomposes
    over chunks, and no real query reads past its own position. Only the
    float codec is supported (the int8 path quantizes whole prompts at
    prefill end; the engine keeps int8 replicas on single-shot)."""
    if "k_q" in cache:
        raise ValueError("chunked prefill requires a float KV cache")
    h = lookup(params["embed"], tokens)
    posmat = chunk_positions(offsets, tokens.shape[1])
    for li, lp in enumerate(params["layers"]):
        h = block_chunk(lp, h, cfg, dims, cache["k"][li], cache["v"][li],
                        posmat, lengths, rows, attn_backend, shard_fn)
    logits, pos = chunk_logits(params, h, cfg, offsets, lengths)
    return logits, cache, pos
