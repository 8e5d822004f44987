"""Plain PyTorch versions of the port's kernels: the same functions, written
as dense tensor code, in the kernels' own layouts.

The CPU tests hold them to the JAX package, ``ops`` runs them for tensors
on the CPU, and ``chip_smoke.py`` holds each CUDA kernel to them on the
card. Both take a ragged S (no tile size assumed), and ``flash_decode_ref``
takes a per-row ``pos`` (B,) -- the serving slot pool, where every slot sits
at its own fill depth; ``flash_decode_split_ref`` is the same function
computed as the split-KV kernel does, chunk partials merged by their
log-sum-exp. ``gcn_layer_ref`` is one layer of the paper's Eq. 6.
``ssd_scan_ref`` is the Mamba-2 SSD blocked scan over chunks of
``ssd_chunk_ref``.
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


def flash_decode_split_ref(q, k_cache, v_cache, pos, chunk):
    """``flash_decode_ref`` as the split-KV kernel computes it: row b's
    positions 0..pos[b] are cut into chunks of ``chunk``; each chunk leaves
    a partial over its live positions -- max m, sum l of exp(s - m) and the
    unnormalised output acc, in f32. A row with one chunk returns acc / l;
    a row with more merges its partials by their log-sum-exp. Returns
    (B, G, qpg, hd) in q's dtype."""
    B, G, qpg, hd = q.shape
    S = k_cache.shape[1]
    n = -(-S // chunk)
    pad = (0, 0, 0, 0, 0, n * chunk - S)     # the sequence axis to n chunks
    k = torch.nn.functional.pad(k_cache.float(), pad)
    v = torch.nn.functional.pad(v_cache.float(), pad)
    pos = torch.as_tensor(pos, device=q.device).reshape(-1).expand(B)
    last = pos.long().clamp(max=S - 1)
    s = torch.einsum("bgqh,btgh->bgqt", q.float(), k) / math.sqrt(hd)
    live = torch.arange(n * chunk, device=q.device)[None, :] <= last[:, None]
    s = torch.where(live[:, None, None, :], s, -math.inf)
    s = s.reshape(B, G, qpg, n, chunk)
    m = s.amax(dim=-1)                       # -inf for a chunk with nothing
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bgqnc,bncgh->bgqnh", p,
                       v.reshape(B, n, chunk, G, hd))
    one = acc[..., 0, :] / torch.where(l[..., :1] > 0, l[..., :1], 1.0)
    w = torch.exp(m - m.amax(dim=-1, keepdim=True))
    merged = (w[..., None] * acc).sum(dim=-2) \
        / (w * l).sum(dim=-1, keepdim=True)
    n_live = torch.div(last, chunk, rounding_mode="trunc") + 1
    out = torch.where((n_live == 1)[:, None, None, None], one, merged)
    return out.to(q.dtype)


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


def ssd_chunk_ref(x, a, Bm, Cm, state):
    """One SSD chunk of the blocked algorithm, in f32. x: (B, Q, H, P)
    dt-preweighted inputs; a: (B, Q, H) log decays; Bm, Cm: (B, Q, N) (one
    group); state: (B, H, P, N) carried in. Returns (y (B, Q, H, P),
    new state). Each product is a two-operand einsum, so no (B, Q, N, H, P)
    outer product is ever formed."""
    x, a, Bm, Cm = x.float(), a.float(), Bm.float(), Cm.float()
    Q = x.shape[1]
    a_cum = torch.cumsum(a, dim=1)                           # (B, Q, H)
    diff = a_cum[:, :, None, :] - a_cum[:, None, :, :]       # (B, Q, K, H)
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    L = torch.where(tri[None, :, :, None], torch.exp(diff), 0.0)
    scores = torch.einsum("bqn,bkn->bqk", Cm, Bm)
    y_diag = torch.einsum("bqkh,bkhp->bqhp", L * scores[..., None], x)
    y_off = torch.einsum("bqn,bhpn->bqhp", Cm, state) \
        * torch.exp(a_cum)[..., None]
    decay_out = torch.exp(a_cum[:, -1:, :] - a_cum)          # (B, Q, H)
    new_state = state * torch.exp(a_cum[:, -1])[:, :, None, None] + \
        torch.einsum("bkn,bkhp->bhpn", Bm, x * decay_out[..., None])
    return y_diag + y_off, new_state


def ssd_scan_ref(x, a, Bm, Cm, chunk):
    """The scan from a zero state: ``ssd_chunk_ref`` over consecutive
    chunks of ``chunk`` steps (the last may be shorter). Returns
    (y (B, T, H, P) f32, final state (B, H, P, N) f32)."""
    B, T, H, P = x.shape
    state = torch.zeros((B, H, P, Bm.shape[-1]), dtype=torch.float32,
                        device=x.device)
    ys = []
    for c0 in range(0, T, chunk):
        y, state = ssd_chunk_ref(x[:, c0:c0 + chunk], a[:, c0:c0 + chunk],
                                 Bm[:, c0:c0 + chunk], Cm[:, c0:c0 + chunk],
                                 state)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def gcn_layer_ref(a_hat, x, w, b, *, relu=True):
    """relu?(a_hat . x . w + b) in f32. a_hat: (N, N); x: (N, F) or
    (Bt, N, F); w: (F, H); b: (H,). Returns (..., N, H) in x's dtype."""
    h = torch.matmul(a_hat.float(), x.float()) @ w.float() + b.float()
    if relu:
        h = torch.relu(h)
    return h.to(x.dtype)
