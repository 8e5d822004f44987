"""Mamba-2 LM (ssm family) and the Zamba-2-style hybrid (a Mamba-2 backbone
with one shared attention block invoked every ``attn_every`` layers, each
invocation with its own KV cache): the port of ``repro.models.ssm_lm``,
its training forward ``ssm_forward`` and its serving half.

Parameters are a plain dict: ``embed``, ``final_norm``, ``lm_head`` unless
embeddings are tied, ``layers`` (a list of ``{"norm", "mamba"}`` dicts; the
reference stacks them for ``lax.scan``) and, for the hybrid, one unstacked
``shared_attn`` block (``attn_norm``, ``attn``, ``ffn_norm``, ``mlp``: a
dense layer's keys).

The serve state is a dict: ``ssm`` (L, B, H, P, N) f32, ``conv``
(L, B, W-1, C) in the cache dtype and, for the hybrid, ``attn_k`` /
``attn_v`` (n_inv, B, S, G, hd). Prefill and decode write it in place, one
layer view at a time (the reference updates it functionally and relies on
jit buffer donation: at full width mamba2's SSM state is ~100 MB per row).
Decode is O(1) in context for the mamba layers. A chunked prefill
(``ssm_prefill_chunk``) continues the carried SSM and conv state and the
hybrid's KV caches one chunk at a time. The int8 KV codec is refused: this
family keeps SSM and conv state in float. The training forward scans
through ``ssd_chunked`` and attends through einsum (the kernels have no
backward).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.dims import PaddedDims
from repro_torch.models.layers import fresh_state, he_init, lookup, rms_norm
from repro_torch.models.lm import (block_chunk, block_decode, block_prefill,
                                   chunk_logits, chunk_positions, init_mlp,
                                   last_logits, remat_policy, train_block,
                                   _logits)
from repro_torch.models.ssd import (init_mamba2, mamba2_decode,
                                    mamba2_forward, mamba2_init_state)


def n_invocations(cfg: ArchConfig) -> int:
    """How often the hybrid's shared attention block runs in one pass."""
    if cfg.family != "hybrid" or not cfg.attn_every:
        return 0
    return (cfg.num_layers + cfg.attn_every - 1) // cfg.attn_every


def _invocation(cfg: ArchConfig, li: int):
    """The shared block's invocation index before layer ``li``, or None."""
    if cfg.family == "hybrid" and li % cfg.attn_every == 0:
        return li // cfg.attn_every
    return None


def init_ssm_lm(gen: torch.Generator, cfg: ArchConfig, dims: PaddedDims,
                dtype=torch.float32) -> dict:
    """Random weights from ``gen``, on ``gen``'s device."""
    dev = gen.device
    zeros = dict(dtype=torch.float32, device=dev)
    params = {
        "embed": (torch.randn((dims.vocab, cfg.d_model), generator=gen,
                              device=dev) * 0.02).to(dtype),
        "final_norm": torch.zeros((cfg.d_model,), **zeros),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = he_init(gen, (cfg.d_model, dims.vocab), dtype,
                                    cfg.d_model)
    params["layers"] = [
        {"norm": torch.zeros((cfg.d_model,), **zeros),
         "mamba": init_mamba2(gen, cfg.d_model, cfg.d_inner, cfg.ssm_heads,
                              cfg.ssm_head_dim, cfg.ssm_state,
                              cfg.ssm_groups, cfg.ssm_conv_width, dtype)}
        for _ in range(cfg.num_layers)]
    if cfg.family == "hybrid":
        params["shared_attn"] = {
            "attn_norm": torch.zeros((cfg.d_model,), **zeros),
            "attn": attn.init_attention(gen, cfg.d_model, dims,
                                        cfg.resolved_head_dim, False, dtype),
            "ffn_norm": torch.zeros((cfg.d_model,), **zeros),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                            dtype),
        }
    return params


def _train_layer(lp, shared, h, cfg, dims, positions, shard_fn=None):
    """Layer ``lp`` over a whole sequence, after the hybrid's shared block
    when ``shared`` is given (einsum attention, ``ssd_chunked``)."""
    if shared is not None:
        h, _ = train_block(shared, h, cfg, dims, positions, shard_fn)
    return h + mamba2_forward(lp["mamba"],
                              rms_norm(h, lp["norm"], cfg.norm_eps), cfg,
                              attn_backend="einsum")


def ssm_forward(params, batch, cfg: ArchConfig, dims: PaddedDims, *,
                remat: str = "none", shard_fn=None,
                return_features: bool = False):
    """Full-sequence training forward: (logits (B, S, V), aux = 0), or
    (features (B, S, d), 0) with ``return_features``. The hybrid's shared
    block runs before layer i when i % attn_every == 0; under ``remat``
    it is recomputed with its layer. ``shard_fn`` places the activations
    ("act_btd" after the embedding and each layer, the shared block's
    "qkv"/"kv", "logits")."""
    run = remat_policy(remat)
    h = lookup(params["embed"], batch["tokens"])
    if shard_fn is not None:
        h = shard_fn(h, "act_btd")
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    for li, lp in enumerate(params["layers"]):
        shared = params["shared_attn"] \
            if _invocation(cfg, li) is not None else None
        h = run(_train_layer, lp, shared, h, cfg, dims, positions, shard_fn)
        if shard_fn is not None:
            h = shard_fn(h, "act_btd")
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if return_features:
        return h, aux
    logits = _logits(params, h)
    if shard_fn is not None:
        logits = shard_fn(logits, "logits")
    return logits, aux


def ssm_init_state(cfg, dims, batch: int, max_len: int, dtype=torch.bfloat16,
                   device="cuda") -> dict:
    if isinstance(dtype, str):
        raise ValueError(f"cache dtype {dtype!r} needs an attention KV pool; "
                         f"family={cfg.family!r} keeps SSM/conv state in "
                         "float")
    st = mamba2_init_state(batch, cfg, dtype, device)
    state = {n: t.new_zeros((cfg.num_layers,) + tuple(t.shape))
             for n, t in st.items()}
    if cfg.family == "hybrid":
        shape = (n_invocations(cfg), batch, max_len, dims.n_kv,
                 cfg.resolved_head_dim)
        state["attn_k"] = torch.zeros(shape, dtype=dtype, device=device)
        state["attn_v"] = torch.zeros(shape, dtype=dtype, device=device)
    return state


def ssm_prefill(params, batch, cfg: ArchConfig, dims: PaddedDims, *,
                cache_len: int, cache_dtype=torch.bfloat16,
                attn_backend: str = "pallas", shard_fn=None):
    """Prefill: returns (last-token logits, serve state, pos (B,) int32).
    ``shard_fn`` lays out a sharded run's fresh state ("serve_state");
    no activation tag applies in this family's serve path, as in the
    reference.

    ``batch["lengths"]`` (B,) enables right-padded bucketed prompts: padded
    steps are exactly inert for the SSM state (dt = 0), the conv state is
    gathered from the last real positions, and logits come from
    ``lengths - 1``. ``attn_backend="pallas"`` runs every layer's scan
    through ``ops.ssd_scan`` and the shared block through
    ``ops.flash_attention``; ``"einsum"`` runs the reference's dense
    paths. A fleet group's head layout as ``shard_fn``
    (``sharding.HeadLayout``) lays the state out in head blocks: the
    scans, convs and the shared block's attention run on them."""
    tokens = batch["tokens"]
    lengths = batch.get("lengths")
    h = lookup(params["embed"], tokens)
    state = fresh_state(ssm_init_state, h, shard_fn, cfg, dims,
                        tokens.shape[0], cache_len, cache_dtype)
    for li, lp in enumerate(params["layers"]):
        inv = _invocation(cfg, li)
        if inv is not None:
            h = block_prefill(params["shared_attn"], h, cfg, dims,
                              state["attn_k"][inv], state["attn_v"][inv],
                              attn_backend)
        layer = {n: state[n][li] for n in ("ssm", "conv")}
        y, st = mamba2_forward(lp["mamba"],
                               rms_norm(h, lp["norm"], cfg.norm_eps), cfg,
                               return_state=True, lengths=lengths,
                               attn_backend=attn_backend, over=layer)
        h = h + y
        layer["ssm"].copy_(st["ssm"])
        layer["conv"].copy_(st["conv"])
    logits, pos = last_logits(params, h, cfg, lengths)
    return logits, state, pos


def ssm_decode(params, state, tokens, pos, cfg: ArchConfig,
               dims: PaddedDims, *, attn_backend: str = "pallas",
               write_rows=None, shard_fn=None):
    """One decode step. tokens: (B, 1) int; pos: (B,) int32, each row's
    cache write index (the hybrid's attention). ``shard_fn``: as in
    ``ssm_prefill``. Updates ``state`` in place
    -- only rows ``write_rows`` (an int index tensor) when given: the
    fleet's non-stepping rows keep their SSM, conv and attention state bit
    for bit -- and returns (logits (B, V), state)."""
    h = lookup(params["embed"], tokens)                              # (B, 1, d)
    for li, lp in enumerate(params["layers"]):
        inv = _invocation(cfg, li)
        if inv is not None:
            h = block_decode(params["shared_attn"], h, cfg, dims,
                             {"k": state["attn_k"][inv],
                              "v": state["attn_v"][inv]}, pos,
                             attn_backend, write_rows)
        y, _ = mamba2_decode(lp["mamba"],
                             rms_norm(h, lp["norm"], cfg.norm_eps), cfg,
                             {"ssm": state["ssm"][li],
                              "conv": state["conv"][li]}, rows=write_rows,
                             attn_backend=attn_backend)
        h = h + y
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _logits(params, h)[:, 0], state


def ssm_prefill_chunk(params, state, tokens, offsets, lengths,
                      cfg: ArchConfig, dims: PaddedDims, *, rows=None,
                      attn_backend: str = "pallas", shard_fn=None):
    """Continue a prefill one chunk at a time: ``state`` is the serve state
    left by earlier chunks (zeros for a first chunk), row b of the batch in
    state row ``rows[b]`` (default b); ``tokens`` (B, C) the next chunk
    right-padded to the fixed width with ``lengths`` (B,) true counts;
    ``offsets`` (B,) the absolute position of each row's chunk start.

    Each layer's scan seeds from the carried SSM state, its conv window
    rides the carried raw tail (the layout ``mamba2_decode`` keeps), and
    the hybrid's shared block writes and reads its per-invocation KV
    caches at the chunk's absolute positions
    (``attention.chunk_prefill_attention``), so chunk by chunk equals the
    single-shot prefill (pad steps are dt = 0, inert). The rows' state is
    updated in place. Returns (last-real-token logits, state, pos (B,) =
    offset + length). ``shard_fn``: as in ``ssm_prefill``."""
    h = lookup(params["embed"], tokens)
    B = tokens.shape[0]
    if rows is None:
        rows = torch.arange(B, dtype=torch.int32, device=h.device)
    r = rows.long()
    posmat = chunk_positions(offsets, tokens.shape[1])
    for li, lp in enumerate(params["layers"]):
        inv = _invocation(cfg, li)
        if inv is not None:
            h = block_chunk(params["shared_attn"], h, cfg, dims,
                            state["attn_k"][inv], state["attn_v"][inv],
                            posmat, lengths, rows, attn_backend)
        ssm, conv = state["ssm"][li], state["conv"][li]
        y, st = mamba2_forward(lp["mamba"],
                               rms_norm(h, lp["norm"], cfg.norm_eps), cfg,
                               init_state=ssm[r], conv_state=conv[r],
                               return_state=True, lengths=lengths,
                               attn_backend=attn_backend,
                               over={"ssm": ssm, "conv": conv})
        h = h + y
        ssm[r] = st["ssm"]
        conv[r] = st["conv"].to(conv.dtype)
    logits, pos = chunk_logits(params, h, cfg, offsets, lengths)
    return logits, state, pos
