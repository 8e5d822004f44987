"""Plain PyTorch versions of the port's kernels: the same functions, written
as dense tensor code, in the kernels' own layouts.

The CPU tests hold them to the JAX package, ``ops`` runs them for tensors
on the CPU, and ``chip_smoke.py`` holds each CUDA kernel to them on the
card. Both take a ragged S (no tile size assumed), and ``flash_decode_ref``
takes a per-row ``pos`` (B,) -- the serving slot pool, where every slot sits
at its own fill depth. ``gcn_layer_ref`` is one layer of the paper's Eq. 6.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_decode_ref(q, k_cache, v_cache, pos):
    """q: (B, G, qpg, hd); caches: (B, S, G, hd); pos: (B,) int or scalar.
    Row b attends cache positions 0..pos[b] inclusive. Returns
    (B, G, qpg, hd) in q's dtype; computes in f32."""
    B, G, qpg, hd = q.shape
    S = k_cache.shape[1]
    pos = torch.as_tensor(pos, device=q.device).reshape(-1).expand(B)
    s = torch.einsum("bgqh,btgh->bgqt", q.float(), k_cache.float()) \
        / math.sqrt(hd)
    mask = torch.arange(S, device=q.device)[None, :] <= pos[:, None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bgqt,btgh->bgqh", p, v_cache.float()).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal=True):
    """q: (B, S, G, qpg, hd); k, v: (B, T, G, hd). Causal masks key t > query
    s + (T - S). Returns (B, S, G, qpg, hd) in q's dtype; computes in f32."""
    S, hd = q.shape[1], q.shape[-1]
    T = k.shape[1]
    s = torch.einsum("bsgqh,btgh->bgqst", q.float(), k.float()) \
        / math.sqrt(hd)
    if causal:
        mask = torch.ones(S, T, dtype=torch.bool, device=q.device) \
            .tril(diagonal=T - S)
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bgqst,btgh->bsgqh", p, v.float()).to(q.dtype)


def gcn_layer_ref(a_hat, x, w, b, *, relu=True):
    """relu?(a_hat . x . w + b) in f32. a_hat: (N, N); x: (N, F) or
    (Bt, N, F); w: (F, H); b: (H,). Returns (..., N, H) in x's dtype."""
    h = torch.matmul(a_hat.float(), x.float()) @ w.float() + b.float()
    if relu:
        h = torch.relu(h)
    return h.to(x.dtype)
