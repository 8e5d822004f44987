"""Whisper-style encoder-decoder, the audio family (the port of
``repro.models.encdec``: the training forward ``encdec_forward`` and the
serve path).

The conv/mel frontend is a stub, as in the reference: a request carries
precomputed frame embeddings (B, encoder_seq_len, d_model) as its
``frame_embeds``. The encoder adds sinusoidal positions and runs full
(non-causal) self-attention; the decoder adds learned positions
(``dec_pos``) and runs causal self-attention, then cross-attention over the
encoder's output. LayerNorm and GELU, as the original Whisper.

Parameters are a plain dict: ``embed`` (V, d) (tied: the head is its
transpose), ``dec_pos`` (max_decoder_pos, d), ``enc_layers`` and
``dec_layers``, lists of one dict per layer (``attn_norm``, ``attn``,
``ffn_norm``, ``mlp``; a decoder layer also ``cross_norm`` and ``cross``;
each norm a LayerNorm ``scale``/``bias``), ``enc_final_norm`` and
``dec_final_norm``. The reference stacks each layer list along a leading
axis for ``lax.scan``; ``repro_torch.bridge`` maps one onto the other.

The serve state: ``self_k`` / ``self_v`` (L, B, S, G, hd), the decoder's
self-attention cache, and ``cross_k`` / ``cross_v`` (L, B, Le, G, hd), the
encoder output's projected K/V, written once at prefill in the cache's
dtype. On ``"pallas"`` every attention runs through the kernels: the
encoder's through ``ops.flash_attention(causal=False)`` over Le frames, the
decoder prefill's self-attention causal, its cross-attention full over Le
keys; a decode step's self-attention through ``ops.flash_decode`` at each
row's ``pos`` and its cross-attention through ``ops.flash_decode`` over the
cross cache with every row at position Le - 1, which is the reference's
dense softmax over all Le keys. ``"einsum"`` keeps the reference's dense
paths; the training forward takes it (the kernels have no backward), with
``remat`` (``lm.remat_policy``) over encoder and decoder layers.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.dims import PaddedDims
from repro_torch.models.layers import (fresh_state, layer_norm, lookup,
                                       sinusoidal_positions_on)
from repro_torch.models.lm import init_mlp, mlp_apply, remat_policy


def _ln_init(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def _enc_layer_init(gen, cfg: ArchConfig, dims: PaddedDims, dtype) -> dict:
    dev = gen.device
    return {
        "attn_norm": _ln_init(cfg.d_model, dev),
        "attn": attn.init_attention(gen, cfg.d_model, dims,
                                    cfg.resolved_head_dim, True, dtype),
        "ffn_norm": _ln_init(cfg.d_model, dev),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation, dtype),
    }


def _dec_layer_init(gen, cfg: ArchConfig, dims: PaddedDims, dtype) -> dict:
    p = _enc_layer_init(gen, cfg, dims, dtype)
    p["cross_norm"] = _ln_init(cfg.d_model, gen.device)
    p["cross"] = attn.init_attention(gen, cfg.d_model, dims,
                                     cfg.resolved_head_dim, True, dtype)
    return p


def init_encdec(gen: torch.Generator, cfg: ArchConfig, dims: PaddedDims,
                dtype=torch.float32) -> dict:
    """Random weights from ``gen``, on ``gen``'s device."""
    dev = gen.device
    return {
        "embed": (torch.randn((dims.vocab, cfg.d_model), generator=gen,
                              device=dev) * 0.02).to(dtype),
        "dec_pos": (torch.randn((cfg.max_decoder_pos, cfg.d_model),
                                generator=gen, device=dev) * 0.01).to(dtype),
        "enc_layers": [_enc_layer_init(gen, cfg, dims, dtype)
                       for _ in range(cfg.encoder_layers)],
        "enc_final_norm": _ln_init(cfg.d_model, dev),
        "dec_layers": [_dec_layer_init(gen, cfg, dims, dtype)
                       for _ in range(cfg.num_layers)],
        "dec_final_norm": _ln_init(cfg.d_model, dev),
    }


def _ln(x, p, eps):
    return layer_norm(x, p["scale"], p["bias"], eps)


def _enc_layer(lp, h, cfg, dims, attn_backend, shard_fn=None):
    x = _ln(h, lp["attn_norm"], cfg.norm_eps)
    h = h + attn.attention(lp["attn"], x, dims, causal=False,
                           backend=attn_backend, shard_fn=shard_fn)
    x = _ln(h, lp["ffn_norm"], cfg.norm_eps)
    return h + mlp_apply(lp["mlp"], x, cfg.activation)


def encode(params, frame_embeds, cfg: ArchConfig, dims: PaddedDims, *,
           attn_backend: str = "pallas", remat: str = "none",
           shard_fn=None):
    """The encoder over ``frame_embeds`` (B, Le, d): (B, Le, d);
    ``shard_fn`` places each attention's q, k, v."""
    run = remat_policy(remat)
    Le = frame_embeds.shape[1]
    pos = sinusoidal_positions_on(Le, cfg.d_model, frame_embeds.device)
    h = frame_embeds + pos.to(frame_embeds.dtype)[None]
    for lp in params["enc_layers"]:
        h = run(_enc_layer, lp, h, cfg, dims, attn_backend, shard_fn)
    return _ln(h, params["enc_final_norm"], cfg.norm_eps)


def _dec_layer(lp, h, enc_out, cfg, dims, shard_fn=None):
    """One decoder layer over a whole sequence (teacher forcing): causal
    self-attention, cross-attention over ``enc_out``, the MLP; einsum."""
    x = _ln(h, lp["attn_norm"], cfg.norm_eps)
    h = h + attn.attention(lp["attn"], x, dims, causal=True,
                           backend="einsum", shard_fn=shard_fn)
    x = _ln(h, lp["cross_norm"], cfg.norm_eps)
    h = h + attn.attention(lp["cross"], x, dims, causal=False, kv_x=enc_out,
                           backend="einsum", shard_fn=shard_fn)
    x = _ln(h, lp["ffn_norm"], cfg.norm_eps)
    return h + mlp_apply(lp["mlp"], x, cfg.activation)


def _decoder_stack(params, h, enc_out, cfg, dims, *, remat: str = "none",
                   shard_fn=None):
    run = remat_policy(remat)
    for lp in params["dec_layers"]:
        h = run(_dec_layer, lp, h, enc_out, cfg, dims, shard_fn)
    return _ln(h, params["dec_final_norm"], cfg.norm_eps)


def encdec_forward(params, batch, cfg: ArchConfig, dims: PaddedDims, *,
                   remat: str = "none", shard_fn=None,
                   return_features: bool = False):
    """Training forward (teacher forcing) of ``batch["frame_embeds"]``
    (B, Le, d) and ``batch["tokens"]`` (B, S): (logits (B, S, V), aux = 0),
    or (features (B, S, d), 0) with ``return_features``. ``shard_fn``
    places every attention's q, k, v and the logits."""
    enc_out = encode(params, batch["frame_embeds"], cfg, dims,
                     attn_backend="einsum", remat=remat, shard_fn=shard_fn)
    toks = batch["tokens"]
    h = _decoder_in(params, toks, torch.arange(toks.shape[1],
                                               device=toks.device))
    h = _decoder_stack(params, h, enc_out, cfg, dims, remat=remat,
                       shard_fn=shard_fn)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if return_features:
        return h, aux
    logits = h @ params["embed"].T
    if shard_fn is not None:
        logits = shard_fn(logits, "logits")
    return logits, aux


# ------------------------------------------------------------------ serving
def encdec_init_state(cfg, dims, batch: int, max_len: int,
                      dtype=torch.bfloat16, device="cuda") -> dict:
    if isinstance(dtype, str):
        raise ValueError(f"cache dtype {dtype!r}: the audio family keeps "
                         "its caches in float")
    hd = cfg.resolved_head_dim
    L, Le = cfg.num_layers, cfg.encoder_seq_len
    zeros = lambda n: torch.zeros((L, batch, n, dims.n_kv, hd), dtype=dtype,
                                  device=device)
    return {"self_k": zeros(max_len), "self_v": zeros(max_len),
            "cross_k": zeros(Le), "cross_v": zeros(Le)}


def _decoder_in(params, tokens, positions):
    """Token embeddings plus the learned positions: ``positions`` (S,)
    shared by every row, or (B, 1) one a row."""
    return (lookup(params["embed"], tokens)
            + lookup(params["dec_pos"], positions.long()))


def encdec_prefill(params, batch, cfg, dims, *, cache_len: int,
                   cache_dtype=torch.bfloat16, attn_backend: str = "pallas",
                   shard_fn=None):
    """Encode ``batch["frame_embeds"]``, then the decoder over
    ``batch["tokens"]`` (B, S), filling the self cache at [0, S) and the
    cross cache whole. Returns (last-token logits (B, V), state, pos (B,)
    int32 = S). ``shard_fn`` places the encoder's q, k, v, as in the
    reference, and lays out a sharded run's fresh state."""
    enc_out = encode(params, batch["frame_embeds"], cfg, dims,
                     attn_backend=attn_backend, shard_fn=shard_fn)
    toks = batch["tokens"]
    B, S = toks.shape
    h = _decoder_in(params, toks, torch.arange(S, device=toks.device))
    state = fresh_state(encdec_init_state, h, shard_fn, cfg, dims, B,
                        cache_len, cache_dtype)
    for li, lp in enumerate(params["dec_layers"]):
        x = _ln(h, lp["attn_norm"], cfg.norm_eps)
        h = h + attn.prefill_attention(lp["attn"], x, dims,
                                       state["self_k"][li],
                                       state["self_v"][li],
                                       backend=attn_backend)
        x = _ln(h, lp["cross_norm"], cfg.norm_eps)
        h = h + attn.attention(lp["cross"], x, dims, causal=False,
                               kv_x=enc_out, backend=attn_backend,
                               kv_out=(state["cross_k"][li],
                                       state["cross_v"][li]))
        x = _ln(h, lp["ffn_norm"], cfg.norm_eps)
        h = h + mlp_apply(lp["mlp"], x, cfg.activation)
    h = _ln(h, params["dec_final_norm"], cfg.norm_eps)
    logits = h[:, -1] @ params["embed"].T
    pos = torch.full((B,), S, dtype=torch.int32, device=h.device)
    return logits, state, pos


def encdec_decode(params, state, tokens, pos, cfg: ArchConfig,
                  dims: PaddedDims, *, attn_backend: str = "pallas",
                  write_rows=None, shard_fn=None):
    """One decode step. tokens: (B, 1) int; pos: (B,) int32, each row's
    cache write index and decoder position (``shard_fn`` is taken for the
    facade's sake: no tag applies here, as in the reference). Writes the new self K/V in
    place (rows ``write_rows`` only, when given) and returns
    (logits (B, V), state)."""
    h = _decoder_in(params, tokens, pos[:, None])            # (B, 1, d)
    Le = state["cross_k"].shape[2]
    cross_pos = torch.full_like(pos, Le - 1)     # every row sees all Le
    for li, lp in enumerate(params["dec_layers"]):
        x = _ln(h, lp["attn_norm"], cfg.norm_eps)
        q, k_new, v_new = attn.project_decode_qkv(lp["attn"], x, dims, pos,
                                                  0.0)
        kc, vc = attn.write_kv(state["self_k"][li], state["self_v"][li],
                               k_new, v_new, pos, write_rows)
        h = h + attn.decode_attend(lp["attn"], q, kc, vc, pos, dims,
                                   backend=attn_backend)
        x = _ln(h, lp["cross_norm"], cfg.norm_eps)
        h = h + attn.decode_attend(lp["cross"],
                                   attn.project_q(lp["cross"], x, dims),
                                   state["cross_k"][li], state["cross_v"][li],
                                   cross_pos, dims, backend=attn_backend)
        x = _ln(h, lp["ffn_norm"], cfg.norm_eps)
        h = h + mlp_apply(lp["mlp"], x, cfg.activation)
    h = _ln(h, params["dec_final_norm"], cfg.norm_eps)
    return h[:, 0] @ params["embed"].T, state
