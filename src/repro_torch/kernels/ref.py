"""Plain PyTorch versions of the port's kernels: the same functions, written
as dense tensor code, in the kernels' own layouts.

The CPU tests hold them to the JAX package, ``ops`` runs them for tensors
on the CPU, and ``chip_smoke.py`` holds each CUDA kernel to them on the
card. Both take a ragged S (no tile size assumed), and ``flash_decode_ref``
takes a per-row ``pos`` (B,) -- the serving slot pool, where every slot sits
at its own fill depth; ``flash_decode_split_ref`` is the same function
computed as the split-KV kernel does, chunk partials merged by their
log-sum-exp. ``gcn_layer_ref`` is one layer of the paper's Eq. 6
(``gcn_layer_bwd_ref`` its gradients, by autograd through it), and
``gcn_actor_ref`` the balancer's whole greedy action over it (GCN layers,
``actor_head_ref``'s head, mask and softmax) -- ``core.ddpg``'s layered
path runs the same head after its GCN layers.
``ssd_scan_ref`` is the Mamba-2 SSD blocked scan over chunks of
``ssd_chunk_ref``; ``ssd_scan_tiled_ref`` is the same scan computed as the
CUDA kernel computes it (step tiles, heads in groups sharing one C.B^T
tile, the state's term transposed), with its products at f32, one TF32
pass or the kernel's three (``tf32_round`` splits the operands). Nothing
on the serving path calls it: it is the kernel's arithmetic, for tests.
``ssd_decode_ref`` is one Mamba-2 decode step of the carried state; the
model's einsum backend steps through it too (``per_head`` repeats the B/C
groups over the heads, for it and the model's blocked scan).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def dequantize_kv(q, scale, dtype):
    """An int8 cache (B, S, G, hd) with its f32 scales (B, S, G) as
    ``dtype``: q * scale in f32, then rounded to ``dtype`` -- the
    reference's ``dequantize(...).astype(q.dtype)``."""
    return (q.float() * scale.float()[..., None]).to(dtype)


def _scaled(s, hd: int, scale):
    """Scores ``s`` times the softmax scale: divided by sqrt(hd) when
    ``scale`` is None, else times ``scale``."""
    return s / math.sqrt(hd) if scale is None else s * scale


def flash_decode_ref(q, k_cache, v_cache, pos, k_scale=None, v_scale=None,
                     scale=None):
    """q: (B, G, qpg, hd); caches: (B, S, G, hd); pos: (B,) int or scalar.
    Row b attends cache positions 0..pos[b] inclusive. An int8 cache comes
    with its scales ``k_scale`` / ``v_scale`` (B, S, G) and is dequantized
    to q's dtype first. ``scale``: the softmax scale, 1/sqrt(hd) when
    None. Returns (B, G, qpg, hd) in q's dtype; computes in f32."""
    if k_scale is not None:
        k_cache = dequantize_kv(k_cache, k_scale, q.dtype)
        v_cache = dequantize_kv(v_cache, v_scale, q.dtype)
    B, G, qpg, hd = q.shape
    S = k_cache.shape[1]
    pos = torch.as_tensor(pos, device=q.device).reshape(-1).expand(B)
    s = _scaled(torch.einsum("bgqh,btgh->bgqt", q.float(), k_cache.float()),
                hd, scale)
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


def flash_attention_ref(q, k, v, *, causal=True, q_offset=None,
                        kv_rows=None, scale=None):
    """q: (B, S, G, qpg, hd); k, v: (B, T, G, hd), or (R, T, G, hd) with
    ``kv_rows`` (B,) naming each q row's k/v row. Without ``q_offset``
    causal masks key t > query s + (T - S); with ``q_offset`` (B,) query s
    of row b sits at position q_offset[b] + s and sees keys up to it.
    ``scale``: the softmax scale, 1/sqrt(hd) when None. Returns
    (B, S, G, qpg, hd) in q's dtype; computes in f32."""
    if kv_rows is not None:
        k, v = k[kv_rows.long()], v[kv_rows.long()]
    S, hd = q.shape[1], q.shape[-1]
    T = k.shape[1]
    s = _scaled(torch.einsum("bsgqh,btgh->bgqst", q.float(), k.float()), hd,
                scale)
    if causal:
        if q_offset is None:
            mask = torch.ones(S, T, dtype=torch.bool, device=q.device) \
                .tril(diagonal=T - S)
        else:
            qpos = q_offset.long()[:, None] + torch.arange(S, device=q.device)
            mask = (torch.arange(T, device=q.device)[None, None, :]
                    <= qpos[:, :, None])[:, None, None]   # (B, 1, 1, S, T)
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


def ssd_scan_ref(x, a, Bm, Cm, chunk, init_state=None):
    """The scan from ``init_state`` (B, H, P, N), zeros when None:
    ``ssd_chunk_ref`` over consecutive chunks of ``chunk`` steps (the last
    may be shorter). Returns (y (B, T, H, P) f32, final state
    (B, H, P, N) f32)."""
    B, T, H, P = x.shape
    state = torch.zeros((B, H, P, Bm.shape[-1]), dtype=torch.float32,
                        device=x.device) if init_state is None \
        else init_state.float()
    ys = []
    for c0 in range(0, T, chunk):
        y, state = ssd_chunk_ref(x[:, c0:c0 + chunk], a[:, c0:c0 + chunk],
                                 Bm[:, c0:c0 + chunk], Cm[:, c0:c0 + chunk],
                                 state)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def per_head(t, rep: int, dim: int):
    """Repeat each B/C group ``rep`` times along ``dim`` (groups -> heads),
    as ``jnp.repeat`` does, by a broadcast: no count goes to the host."""
    shape = list(t.shape)
    t = t.unsqueeze(dim + 1).expand(*shape[:dim + 1], rep, *shape[dim + 1:])
    return t.reshape(*shape[:dim], shape[dim] * rep, *shape[dim + 1:])


def ssd_decode_ref(state, x, dt, A, Bm, Cm, write=None):
    """One Mamba-2 decode step of every row's carried state, in place.
    state: (B, H, P, N) f32, updated in place -- only the rows of
    ``write`` (an int index tensor, duplicates allowed) when given, the
    others keeping theirs bit for bit; x: (B, H, P); dt: (B, H) f32; A:
    (H,) f32; Bm, Cm: (B, G, N) with H % G == 0. Returns y (B, H, P) f32,
    the new state read out by C."""
    rep = x.shape[1] // Bm.shape[1]
    bh = per_head(Bm, rep, 1).float()
    ch = per_head(Cm, rep, 1).float()
    decay = torch.exp((dt * A[None, :]).float())[:, :, None, None]
    inp = (x * dt[..., None]).float()[..., None] * bh[:, :, None, :]
    if write is None:
        new = state.mul_(decay).add_(inp)
    else:
        new = state * decay + inp
        state[write] = new[write]
    return torch.einsum("bhpn,bhn->bhp", new, ch)


def tf32_round(v):
    """``v`` (f32) rounded to TF32, a 10-bit mantissa, as
    ``cvt.rna.tf32.f32`` does: to nearest, ties away from zero, on the
    int32 view (the low 13 bits cleared)."""
    i = v.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


SSD_PRECISIONS = ("f32", "tf32", "3xtf32")


def _mm(a, b, precision):
    """a @ b in f32 with each operand as the kernel feeds the tensor
    cores: unrounded ("f32"), rounded to TF32 once ("tf32"), or split into
    hi = tf32(v), lo = tf32(v - hi) and summed as lo.hi + hi.lo + hi.hi
    ("3xtf32"; lo.lo is below f32's last bit)."""
    if precision == "f32":
        return a @ b
    ah, bh = tf32_round(a), tf32_round(b)
    if precision == "tf32":
        return ah @ bh
    if precision != "3xtf32":
        raise ValueError(f"precision {precision!r} not in {SSD_PRECISIONS}")
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def ssd_scan_tiled_ref(x, a, Bm, Cm, *, tile=64, heads_per_block=1,
                       precision="3xtf32"):
    """The scan from a zero state as ``csrc/ssd_scan.cu`` computes it:
    blocks of ``tile`` steps (a ragged last block padded with zero x, a, B
    and C, which are inert); per block and batch row the masked score tile
    S = C.B^T once for each group of ``heads_per_block`` heads, each head
    applying its decay exp(a_cum[q] - a_cum[k]) to it elementwise; y^T =
    exp(a_cum) * (state.C^T) + x^T.(L S)^T and state = exp(a_last) state +
    (x w)^T.B, every product at ``precision``. Returns (y (B, T, H, P),
    final state (B, H, P, N)), f32."""
    x, a, Bm, Cm = x.float(), a.float(), Bm.float(), Cm.float()
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    state = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    tri = torch.ones(tile, tile, dtype=torch.bool, device=x.device).tril()
    ys = []
    for t0 in range(0, T, tile):
        pad = tile - min(tile, T - t0)

        def block(v):
            v = v[:, t0:t0 + tile]
            return torch.nn.functional.pad(
                v, (0, 0) * (v.dim() - 2) + (0, pad))
        xb, ab, bb, cb = block(x), block(a), block(Bm), block(Cm)
        ac = torch.cumsum(ab, dim=1)                          # (B, Q, H)
        y_heads, s_heads = [], []
        for h0 in range(0, H, heads_per_block):
            S = torch.where(tri, _mm(cb, bb.transpose(1, 2), precision),
                            0.0)                              # (B, Q, K)
            for h in range(h0, min(h0 + heads_per_block, H)):
                ach, xh, st = ac[:, :, h], xb[:, :, h], state[:, h]
                L = torch.where(tri, torch.exp(ach[:, :, None]
                                               - ach[:, None, :]), 0.0)
                yt = _mm(st, cb.transpose(1, 2), precision) \
                    * torch.exp(ach)[:, None, :]              # (B, P, Q)
                yt = yt + _mm(xh.transpose(1, 2), (L * S).transpose(1, 2),
                              precision)
                w = torch.exp(ach[:, -1:] - ach)              # (B, Q)
                s_heads.append(
                    st * torch.exp(ach[:, -1])[:, None, None]
                    + _mm((xh * w[..., None]).transpose(1, 2), bb,
                          precision))
                y_heads.append(yt.transpose(1, 2))            # (B, Q, P)
        state = torch.stack(s_heads, dim=1)
        ys.append(torch.stack(y_heads, dim=2)[:, :tile - pad])
    return torch.cat(ys, dim=1), state


def gcn_layer_ref(a_hat, x, w, b, *, relu=True):
    """relu?(a_hat . x . w + b) in f32. a_hat: (N, N); x: (N, F) or
    (Bt, N, F); w: (F, H); b: (H,). Returns (..., N, H) in x's dtype."""
    h = torch.matmul(a_hat.float(), x.float()) @ w.float() + b.float()
    if relu:
        h = torch.relu(h)
    return h.to(x.dtype)


def gcn_layer_bwd_ref(a_hat, x, w, b, dh, *, relu=True, need_dx=True):
    """The gradients of ``gcn_layer_ref`` at (x, w, b) for the output's
    gradient ``dh``, by autograd through it: (dx or None, dw, db). x: (N, F)
    or (Bt, N, F); dh like the output. dw and db sum over the batch."""
    x = x.detach().float().requires_grad_(need_dx)
    w, b = (t.detach().float().requires_grad_() for t in (w, b))
    with torch.enable_grad():
        out = gcn_layer_ref(a_hat, x, w, b, relu=relu)
        leaves = [x, w, b] if need_dx else [w, b]
        grads = torch.autograd.grad(out, leaves, dh.float())
    return (grads[0] if need_dx else None,) + tuple(grads[-2:])


def actor_head_ref(h, obs, head, up_mask=None, noise=None):
    """The actor's head over the GCN's output: logits relu([h, obs] . w1 +
    b1) . w2 + b2, ``+ noise``, -1e9 where ``up_mask`` <= 0, softmax over
    the nodes. h: (..., N, H); obs: (..., N, F); up_mask, noise: broadcast
    to (..., N). Returns the fractions (..., N) in f32."""
    z = torch.cat([h, obs], dim=-1)            # local skip (info fusion)
    logits = (torch.relu(z @ head["w1"] + head["b1"]) @ head["w2"]
              + head["b2"])[..., 0]
    if noise is not None:
        logits = logits + noise
    if up_mask is not None:
        logits = torch.where(up_mask > 0, logits, -1e9)
    return torch.softmax(logits, dim=-1)


def gcn_actor_ref(a_hat, obs, gcn, head, up_mask=None, noise=None):
    """The balancer's greedy action (``repro.core.ddpg.actor_action``): the
    GCN layers of ``gcn`` ({"w": [...], "b": [...]}, relu on all but the
    last) over obs (..., N, F), then ``actor_head_ref``. Returns the
    fractions (..., N)."""
    h = obs
    for i, (w, b) in enumerate(zip(gcn["w"], gcn["b"])):
        h = gcn_layer_ref(a_hat, h, w, b, relu=i < len(gcn["w"]) - 1)
    return actor_head_ref(h, obs, head, up_mask, noise)
