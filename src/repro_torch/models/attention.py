"""GQA attention for the serve path: prefill, decode-with-cache
(the port of ``repro.models.attention``).

Layout is *grouped*, as in the reference: q is (B, S, G, qpg, hd) where
G = physical kv heads and qpg = physical q-heads-per-group (see
``repro_torch.models.dims``); k/v and the caches are (B, S, G, hd).

Two backends compute the same function:

  * ``"pallas"`` (default; the reference's name for its kernel path) --
    prefill through ``ops.flash_attention`` and decode through
    ``ops.flash_decode``: the hand-written CUDA kernels on a CUDA tensor,
    their plain versions on a CPU tensor;
  * ``"einsum"`` -- the reference's dense path, kept as the oracle.

Caches are updated in place: a per-layer cache argument is a view of one
layer of the (L, B, S, G, hd) pool, and the new K/V are written into it.
The kernels read that view by strides in the cache's own dtype, so there
is no transpose and no cast copy of the cache. An int8 pool
(``serving.kv_quant``: int8 K/V with f32 scales) is read by
``ops.flash_decode``, which dequantizes in its loads.

A chunked prefill (``chunk_prefill_attention``) writes one chunk's K/V into
the pool at its cache offset and attends over the filled prefix:
``ops.flash_attention`` with ``q_offset`` on ``"pallas"``, the reference's
masked einsum on ``"einsum"``.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ops, ref
from repro_torch.models.dims import PaddedDims, q_head_mask
from repro_torch.models.layers import (HeadBlocks, apply_rope, he_init,
                                       per_shard)

NEG_INF = -1e9


def init_attention(gen: torch.Generator, d_model: int, dims: PaddedDims,
                   head_dim: int, qkv_bias: bool, dtype) -> dict:
    mask = torch.from_numpy(q_head_mask(dims)).to(gen.device, dtype)
    p = {
        "wq": he_init(gen, (d_model, dims.n_q, head_dim), dtype, d_model)
              * mask[None, :, None],
        "wk": he_init(gen, (d_model, dims.n_kv, head_dim), dtype, d_model),
        "wv": he_init(gen, (d_model, dims.n_kv, head_dim), dtype, d_model),
        "wo": he_init(gen, (dims.n_q, head_dim, d_model), dtype,
                      dims.n_q * head_dim),
    }
    if qkv_bias:
        zeros = dict(dtype=dtype, device=gen.device)
        p["bq"] = torch.zeros((dims.n_q, head_dim), **zeros)
        p["bk"] = torch.zeros((dims.n_kv, head_dim), **zeros)
        p["bv"] = torch.zeros((dims.n_kv, head_dim), **zeros)
    return p


def project_q(params, x, dims: PaddedDims):
    """The grouped queries (B, S, G, qpg, hd) of ``x`` (B, S, d)."""
    B, S, d = x.shape
    hd = params["wq"].shape[-1]
    q = (x @ params["wq"].reshape(d, -1)).reshape(B, S, dims.n_q, hd)
    if "bq" in params:
        q = q + params["bq"]
    return q.reshape(B, S, dims.n_kv, dims.q_per_group, hd)


def _project_qkv(params, x, dims: PaddedDims, kv_x=None):
    """q from ``x`` (B, S, d); k and v from ``kv_x`` (B, T, d), x itself
    when None (cross-attention projects the encoder's output)."""
    kv_x = x if kv_x is None else kv_x
    B, T, d = kv_x.shape
    hd = params["wq"].shape[-1]
    k = (kv_x @ params["wk"].reshape(d, -1)).reshape(B, T, dims.n_kv, hd)
    v = (kv_x @ params["wv"].reshape(d, -1)).reshape(B, T, dims.n_kv, hd)
    if "bk" in params:
        k = k + params["bk"]
        v = v + params["bv"]
    return project_q(params, x, dims), k, v


def _mask_pad_heads(ctx, dims: PaddedDims):
    """Zero the padded q-head outputs so they are exactly inert."""
    if all(dims.q_real):
        return ctx
    m = torch.from_numpy(q_head_mask(dims).reshape(dims.n_kv,
                                                   dims.q_per_group))
    return ctx * m.to(ctx.device, ctx.dtype)[None, None, :, :, None]


def _out_proj(params, ctx, dims: PaddedDims):
    B, S = ctx.shape[:2]
    ctx = _mask_pad_heads(ctx, dims).reshape(B, S, -1)
    return ctx @ params["wo"].reshape(ctx.shape[-1], -1)


def _attend(q, k, v, q_pos, k_pos, causal: bool, scale=None):
    """The reference's dense attention. q: (B,Cq,G,qpg,hd); k,v: (B,T,G,hd);
    positions are int vectors. Scores in f32 (times ``scale``, 1/sqrt(hd)
    when None), probabilities rounded to v's dtype before the P.V
    product."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bsgqh,btgh->bgqst", q.float(), k.float()) * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]          # (Cq, T)
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bgqst,btgh->bsgqh", probs.to(v.dtype), v)


def _attend_ctx(q, k, v, q_pos, k_pos, causal: bool, backend: str,
                scale=None):
    """The attention context of q over k, v on ``backend``: the kernel
    (``ops.flash_attention``, whose causal call needs T == S) or the
    reference's dense path; ``scale`` the softmax scale (1/sqrt(hd) when
    None)."""
    if backend == "pallas":
        return ops.flash_attention(q, k, v, causal=causal, scale=scale)
    if backend == "einsum":
        return _attend(q, k, v, q_pos, k_pos, causal, scale)
    raise ValueError(f"unknown attention backend {backend!r}")


def attention(params, x, dims: PaddedDims, *, positions=None, rope_theta=0.0,
              causal=True, kv_x=None, backend: str = "pallas", kv_out=None,
              shard_fn=None):
    """Full-sequence attention (the reference's ``attention``): the queries
    of ``x`` (B, S, d) over the keys of ``kv_x`` (B, T, d), x itself when
    None -- an encoder's self-attention with ``causal=False``, a decoder's
    cross-attention over the encoder's output with ``kv_x``. ``positions``
    (S,) are the queries' (default 0 .. S-1), the keys' are 0 .. T-1; RoPE
    rotates both when ``rope_theta`` is set. ``kv_out``, a pair of
    (B, T, G, hd) tensors, receives the projected K and V in its own dtype
    (the decoder's cross cache), in place. ``"pallas"`` attends through
    ``ops.flash_attention`` (a causal call needs T == S), ``"einsum"``
    through the reference's dense path. ``shard_fn`` places q ("qkv")
    and k, v ("kv") after RoPE. With a head-split ``kv_out`` (a fleet
    group's cross cache, ``layers.HeadBlocks``) the attention runs on its
    head blocks, each on its device. Returns (B, S, d_model)."""
    S = x.shape[1]
    q, k, v = _project_qkv(params, x, dims, kv_x)
    T = k.shape[1]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    k_pos = torch.arange(T, dtype=torch.int32, device=x.device)
    if rope_theta:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, k_pos, rope_theta)
    if shard_fn is not None:
        q, k, v = shard_fn(q, "qkv"), shard_fn(k, "kv"), shard_fn(v, "kv")
    if kv_out is not None:
        kv_out[0].copy_(k)
        kv_out[1].copy_(v)
    # batch rows (dim 0) and kv-head groups (dim 2) are independent
    ctx = per_shard(_attend_ctx, (q, k, v), (0, 2), positions, k_pos, causal,
                    backend, over=None if kv_out is None else kv_out[0],
                    blocks_only=backend == "pallas")
    return _out_proj(params, ctx, dims)


def prefill_attention(params, x, dims: PaddedDims, k_cache, v_cache, *,
                      rope_theta=0.0, backend: str = "pallas", scale=None):
    """Causal attention over the prompt that also writes its K/V into
    positions [0, S) of the per-layer caches (B, S_cache, G, hd), in place.
    Head-split caches (``layers.HeadBlocks``) take their blocks of K/V,
    and the attention runs on each block at its device's kv heads.
    ``scale``: the softmax scale, 1/sqrt(hd) when None. Returns
    (B, S, d_model)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, x, dims)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    if rope_theta:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    k_cache[:, :S].copy_(k)
    v_cache[:, :S].copy_(v)
    ctx = per_shard(_attend_ctx, (q, k, v), (0, 2), positions, positions,
                    True, backend, scale, over=k_cache,
                    blocks_only=backend == "pallas")
    return _out_proj(params, ctx, dims)


def chunk_prefill_attention(params, x, dims: PaddedDims, k_cache, v_cache,
                            positions, lengths, *, rope_theta=0.0,
                            backend: str = "pallas", rows=None):
    """Continue a prefill one chunk at a time against the per-layer caches
    (R, S, G, hd) (one layer of the serve pool), in place.

    x: (B, C, d) chunk activations; ``positions`` (B, C) int32 are each
    row's absolute cache positions (``offset + arange(C)``), ``lengths``
    (B,) the true token count of each row's chunk, ``rows`` (B,) int32 the
    cache row of each batch row (default: row b). The chunk's K/V are
    written at their positions, then the chunk's queries attend causally
    over the whole cache (``k_pos <= position``), prefix chunks included,
    so chunk-by-chunk prefill equals the single-shot forward. The reference
    parks its pad columns out of bounds and drops them; torch has no
    dropping scatter, so a pad column is written at the cache's last
    position S - 1 instead, which no real query of the chunk reads (a
    prompt keeps at most S - 1 tokens, so real positions end at S - 2) and
    which the row's decode writes before it reads it. Pad rows' outputs
    are computed and discarded, as in the reference. ``"pallas"`` attends
    through ``ops.flash_attention`` in the cache's dtype (q is cast to
    it); ``"einsum"`` is the reference's math, the cache cast to q's dtype.
    Head-split caches (``layers.HeadBlocks``): the write and the attention
    run on each head block on its device. Returns (B, C, d_model)."""
    B, C, _ = x.shape
    q, k, v = _project_qkv(params, x, dims)
    if rope_theta:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    S = k_cache.shape[1]
    j = torch.arange(C, dtype=torch.int32, device=x.device)
    wpos = torch.where(j[None, :] < lengths[:, None], positions, S - 1)
    if rows is None:
        rows = torch.arange(B, dtype=torch.int32, device=x.device)
    ctx = per_shard(_chunk_ctx, (q, k, v, k_cache, v_cache, positions, wpos,
                                 rows), (0, 2), backend, blocks_only=True)
    return _out_proj(params, ctx, dims)


def _chunk_ctx(q, k, v, k_cache, v_cache, positions, wpos, rows,
               backend: str):
    """``chunk_prefill_attention``'s write of the chunk's K/V at ``wpos``
    into cache rows ``rows`` and its attention over the cache: the
    context (B, C, G, qpg, hd) in q's dtype."""
    B, C = wpos.shape
    S = k_cache.shape[1]
    r = rows.long()[:, None].expand(B, C)
    k_cache[r, wpos.long()] = k.to(k_cache.dtype)
    v_cache[r, wpos.long()] = v.to(v_cache.dtype)
    if backend == "pallas":
        ctx = ops.flash_attention(q.to(k_cache.dtype), k_cache, v_cache,
                                  causal=True,
                                  q_offset=positions[:, 0].contiguous(),
                                  kv_rows=rows.contiguous()).to(q.dtype)
    elif backend == "einsum":
        kc, vc = k_cache[rows.long()], v_cache[rows.long()]
        k_pos = torch.arange(S, dtype=torch.int32, device=q.device)
        scale = 1.0 / math.sqrt(q.shape[-1])
        scores = torch.einsum("bsgqh,btgh->bgqst", q.float(),
                              kc.to(q.dtype).float()) * scale
        mask = (k_pos[None, None, :] <= positions[:, :, None])[:, None, None]
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bgqst,btgh->bsgqh", probs.to(vc.dtype),
                           vc).to(q.dtype)
    else:
        raise ValueError(f"unknown attention backend {backend!r}")
    return ctx


def project_decode_qkv(params, x, dims: PaddedDims, pos, rope_theta):
    """Project the new token's q/k/v with RoPE at ``pos`` ((B,) int
    tensor: row b at pos[b])."""
    q, k_new, v_new = _project_qkv(params, x, dims)
    if rope_theta:
        q = apply_rope(q, pos[:, None], rope_theta)
        k_new = apply_rope(k_new, pos[:, None], rope_theta)
    return q, k_new, v_new


def write_kv(k_cache, v_cache, k_new, v_new, pos, rows=None):
    """Write one token's k/v into the (B, S, G, hd) caches in place, row b
    at pos[b] ((B,) int tensor). ``rows`` (an int index tensor) limits the
    write to those rows; every other row keeps its cache bit for bit. An
    empty slot decodes at its stale position, which may be S (its last
    request retired there); the reference's scatter drops that write, and
    here it lands on S - 1, which a slot's next request writes before it
    reads. DTensor caches (batch over data, kv groups over model) are
    written block by block on each rank, every row (no ``rows``);
    head-split caches (``layers.HeadBlocks``) block by block on each
    device, ``rows`` too."""
    if isinstance(k_cache, (DTensor, HeadBlocks)):
        if rows is not None and isinstance(k_cache, DTensor):
            raise ValueError("a sharded cache is written whole: rows=None")
        xs = (k_cache, v_cache, k_new, v_new, pos)
        per_shard(write_kv, xs + ((rows,) if rows is not None else ()),
                  (0, 2), mutates=(0, 1), out_axes=[])
        return k_cache, v_cache
    if rows is None:
        rows = torch.arange(k_cache.shape[0], device=k_cache.device)
        k_new, v_new = k_new[:, 0], v_new[:, 0]
    else:
        k_new, v_new, pos = k_new[rows, 0], v_new[rows, 0], pos[rows]
    idx = pos.long().clamp(max=k_cache.shape[1] - 1)
    k_cache[rows, idx] = k_new.to(k_cache.dtype)
    v_cache[rows, idx] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def decode_attend(params, q, k_cache, v_cache, pos, dims: PaddedDims,
                  backend: str = "pallas", k_scale=None, v_scale=None,
                  scale=None):
    """Read-only attention of a single-token q (B,1,G,qpg,hd) over
    cache[0..pos[b]] per row (pos: (B,) int32 tensor). An int8 cache comes
    with its scales ``k_scale`` / ``v_scale`` (B, S, G). ``"pallas"`` goes
    through ``ops.flash_decode``, which skips the unfilled cache (and
    dequantizes an int8 one in its loads; a float cache in another dtype
    than q is read in its own, q cast to it); ``"einsum"`` is the reference's
    dense path over the whole cache with a mask (an int8 cache dequantized
    whole to q's dtype first, as the reference does). Head-split caches
    (``layers.HeadBlocks``) are read block by block, each on its device at
    its kv heads, and the contexts joined on the lead device. ``scale``:
    the softmax scale, 1/sqrt(hd) when None. Returns (B, 1, d_model)."""
    if backend not in ("pallas", "einsum"):
        raise ValueError(f"unknown attention backend {backend!r}")
    scales = () if k_scale is None else (k_scale, v_scale)
    ctx_fn = _kernel_decode_ctx if backend == "pallas" else _decode_ctx
    # batch rows (dim 0) and kv-head groups (dim 2) are independent
    ctx = per_shard(functools.partial(ctx_fn, scale=scale),
                    (q, k_cache, v_cache, pos) + scales, (0, 2),
                    blocks_only=backend == "pallas")
    return _out_proj(params, ctx, dims)


def _kernel_decode_ctx(q, k_cache, v_cache, pos, k_scale=None,
                       v_scale=None, scale=None):
    """The kernel decode's context (B, 1, G, qpg, hd) in q's dtype. A
    float cache in another dtype than q (an f32 cache under bf16 weights,
    as chunked prefill needs) is read in its own dtype, q cast to it: the
    kernel reads the pool as it lies."""
    qk = q[:, 0] if k_scale is not None else q[:, 0].to(k_cache.dtype)
    return ops.flash_decode(qk, k_cache, v_cache, pos, k_scale, v_scale,
                            scale=scale)[:, None].to(q.dtype)


def _decode_ctx(q, k_cache, v_cache, pos, k_scale=None, v_scale=None,
                scale=None):
    """The einsum decode's context (B, 1, G, qpg, hd) in q's dtype."""
    if k_scale is not None:
        k_cache = ref.dequantize_kv(k_cache, k_scale, q.dtype)
        v_cache = ref.dequantize_kv(v_cache, v_scale, q.dtype)
    T = k_cache.shape[1]
    k_pos = torch.arange(T, dtype=torch.int32, device=q.device)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bsgqh,btgh->bgqst", q.float(),
                          k_cache.to(q.dtype).float()) * scale
    mask = (k_pos[None, :] <= pos[:, None])[:, None, None, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bgqst,btgh->bsgqh", probs.to(v_cache.dtype), v_cache)
    return ctx.to(q.dtype)
