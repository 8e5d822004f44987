"""Plain PyTorch reference of the hybrid_moe family (IBM's
granitemoehybrid, Granite 4.0-H), in float32.

The published equations written out again from the configuration, with
no kernel, cache or batching. The embedding times
``embedding_multiplier``; then per layer, of the kind ``layer_types``
names,

    h += residual_multiplier * mixer(norm(h))
    h += residual_multiplier * (moe(norm(h)) + shared(norm(h)))

where the mixer is a Mamba-2 block (as in ``reference/ssm.py``) or
grouped-query attention with no position embedding
(``position_embedding_type`` "nope"; rotate-half RoPE at ``rope_theta``
otherwise) and softmax scale ``attention_multiplier``; ``moe`` takes the
top ``num_experts_per_tok`` router logits over all ``num_experts``
experts and weights each picked expert's SwiGLU by the softmax over those
logits, and ``shared`` is the always-on SwiGLU of width ``d_ff``. A final
RMSNorm and the tied embedding give the logits, divided by
``logits_scaling``. Imports nothing of the program.

Departures, each noted where it is made:

* the Mamba-2 recurrence runs in chunks of ``ssm_chunk`` steps with the
  state carried between them: ``reference/ssm.py``'s quadratic form would
  take (heads, T, T) float32 matrices, 8.6 GB a layer at T = 4,096; each
  chunk is that same dual form over its own steps;
* attention runs its queries ``Q_BLOCK`` at a time over all keys;
* the experts are the device's share (``experts_held``, ids [0, held)):
  a picked expert that is not held adds nothing, as in the program;
  routing still spans every expert;
* RMSNorm scales by (1 + w), zero-centred, as the dense and ssm
  references and the program do;
* the embedding is drawn at 0.02 / ``embedding_multiplier``, so that it
  enters the residual at granite's initializer range (0.02) as in the
  other configurations: drawn at 0.02 and multiplied by 12, each token's
  own row of the tied embedding outweighs the layers' sum in the head,
  and the next token served is always the last one again, whatever the
  context (a decode that kept no state would still read as sound).

``make_weights`` draws the weights the benchmark hands to both sides, in
the layout of the program's parameter tree (``embed``, ``final_norm``,
``layers`` [{``norm``, ``mamba`` {``in_proj``, ``conv_w``, ``conv_b``,
``out_proj``, ``A_log``, ``D``, ``dt_bias``, ``norm_scale``} or ``attn``
{``wq`` (d, H, hd), ``wk``/``wv`` (d, G, hd), ``wo`` (H, hd, d)},
``ffn_norm``, ``moe`` {``router`` (d, E) f32, ``w_gate``/``w_up`` (held,
d, ff), ``w_down`` (held, ff, d), ``shared`` {``w_gate``/``w_up`` (d, F),
``w_down`` (F, d)}}}]): the matrices from one flat buffer of normal
draws on the device, scaled by 1 / sqrt(fan-in) (the embedding as above);
the router in float32 from the same generator; A, dt, D, biases and norms
as ``reference/ssm.py`` makes them. ``quant="fp8"``: as in
``reference/dense.py``, every matrix product (the router's too) takes its
weight and input rounded to float8 e4m3, the control.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.dense import CHUNK, _mlp, _mm, rms_norm, rope
from portbench.reference.ssm import _dims

Q_BLOCK = 1024           # attention queries a block


def _held(cfg: dict) -> int:
    return cfg.get("experts_held") or cfg["num_experts"]


def _leaves(cfg: dict) -> list:
    """[(path, shape, fan_in)] of the bf16 matrices, in buffer order."""
    d, d_in, H, N, G = _dims(cfg)
    W, V = cfg["ssm_conv_width"], cfg["vocab_size"]
    Hq, Gk, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    ff, sff, E = cfg["moe_d_ff"], cfg["d_ff"], _held(cfg)
    out = [(("embed",), (V, d), None)]
    for i, kind in enumerate(cfg["layer_types"]):
        if kind == "mamba":
            m = ("layers", i, "mamba")
            out += [(m + ("in_proj",), (d, 2 * d_in + 2 * G * N + H), d),
                    (m + ("conv_w",), (W, d_in + 2 * G * N), W),
                    (m + ("out_proj",), (d_in, d), d_in)]
        else:
            a = ("layers", i, "attn")
            out += [(a + ("wq",), (d, Hq, hd), d),
                    (a + ("wk",), (d, Gk, hd), d),
                    (a + ("wv",), (d, Gk, hd), d),
                    (a + ("wo",), (Hq, hd, d), Hq * hd)]
        e, s = ("layers", i, "moe"), ("layers", i, "moe", "shared")
        out += [(e + ("w_gate",), (E, d, ff), d),
                (e + ("w_up",), (E, d, ff), d),
                (e + ("w_down",), (E, ff, d), ff),
                (s + ("w_gate",), (d, sff), d), (s + ("w_up",), (d, sff), d),
                (s + ("w_down",), (sff, d), sff)]
    return out


def make_weights(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    leaves = _leaves(cfg)
    total = sum(math.prod(s) for _, s, _ in leaves)
    flat = torch.empty(total, dtype=dtype, device=device)
    for lo in range(0, total, CHUNK):
        n = min(CHUNK, total - lo)
        flat[lo:lo + n] = torch.randn(n, generator=gen, device=device,
                                      dtype=dtype)
    d, d_in, H, N, G = _dims(cfg)
    kinds = cfg["layer_types"]
    emb = 0.02 / cfg.get("embedding_multiplier", 1.0)
    f32 = dict(dtype=torch.float32, device=device)
    L, E = len(kinds), cfg["num_experts"]
    router = torch.randn((L, d, E), generator=gen, **f32) / math.sqrt(d)
    u = torch.rand((2, L, H), generator=gen, **f32)
    a = 1.0 + 15.0 * u[0]
    dt = torch.exp(math.log(1e-3) + u[1] * (math.log(1e-1) - math.log(1e-3)))
    dt_bias = dt + torch.log(-torch.expm1(-dt))          # inverse softplus
    w = {"embed": None, "final_norm": torch.zeros(d, **f32), "layers": []}
    for i, kind in enumerate(kinds):
        lp = {"norm": torch.zeros(d, **f32), "ffn_norm": torch.zeros(d, **f32),
              "moe": {"router": router[i], "shared": {}}}
        if kind == "mamba":
            lp["mamba"] = {
                "conv_b": torch.zeros(d_in + 2 * G * N, dtype=dtype,
                                      device=device),
                "A_log": torch.log(a[i]), "D": torch.ones(H, **f32),
                "dt_bias": dt_bias[i],
                "norm_scale": torch.zeros(d_in, **f32)}
        else:
            lp["attn"] = {}
        w["layers"].append(lp)
    at = 0
    for path, shape, fan_in in leaves:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        t.mul_(emb if fan_in is None else 1.0 / math.sqrt(fan_in))
        at += n
        if path[0] == "embed":
            w["embed"] = t
            continue
        node = w["layers"][path[1]]
        for key in path[2:-1]:
            node = node[key]
        node[path[-1]] = t
    return w


def _mamba(p, x, cfg, quant):
    """One Mamba-2 block over x (T, d), the recurrence in chunks of
    ``ssm_chunk`` steps with the (H, P, N) state carried between them
    (each chunk in the dual form of ``reference/ssm.py``): (T, d)."""
    d, d_in, H, N, G = _dims(cfg)
    T, P, Q = x.shape[0], cfg["ssm_head_dim"], cfg["ssm_chunk"]
    proj = _mm(x, p["in_proj"].float(), quant)
    z, xbc, dt = proj[:, :d_in], proj[:, d_in:2 * d_in + 2 * G * N], \
        proj[:, 2 * d_in + 2 * G * N:]
    W = p["conv_w"].shape[0]
    xp = F.pad(xbc, (0, 0, W - 1, 0))
    conv = sum(xp[i:i + T] * p["conv_w"][i].float() for i in range(W))
    xbc = F.silu(conv + p["conv_b"].float())
    xs = xbc[:, :d_in].view(T, H, P)
    Bm = xbc[:, d_in:d_in + G * N].view(T, G, N).repeat_interleave(H // G, 1)
    Cm = xbc[:, d_in + G * N:].view(T, G, N).repeat_interleave(H // G, 1)
    dt = F.softplus(dt + p["dt_bias"])                      # (T, H)
    la = dt * -torch.exp(p["A_log"])                        # log decays
    xdt = xs * dt[..., None]
    state = torch.zeros((H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, T, Q):
        c = slice(c0, min(c0 + Q, T))
        n = c.stop - c0
        cum = torch.cumsum(la[c], dim=0)                    # (n, H)
        seg = (cum[:, None, :] - cum[None, :, :]).permute(2, 0, 1)
        causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
        Lm = torch.exp(seg.masked_fill(~causal, float("-inf")))
        cb = torch.einsum("thn,shn->hts", Cm[c], Bm[c])
        y = torch.einsum("hts,shp->thp", Lm * cb, xdt[c])
        y = y + torch.einsum("thn,hpn->thp", Cm[c], state) \
            * torch.exp(cum)[..., None]
        decay = torch.exp(cum[-1][None, :] - cum)           # (n, H)
        state = state * torch.exp(cum[-1])[:, None, None] + torch.einsum(
            "shn,shp->hpn", Bm[c], xdt[c] * decay[..., None])
        ys.append(y)
    y = torch.cat(ys) + xs * p["D"][:, None]
    y = y.reshape(T, d_in) * F.silu(z)
    y = rms_norm(y, p["norm_scale"], cfg.get("norm_eps", 1e-5))
    return _mm(y, p["out_proj"].float(), quant)


def _attention(p, x, cfg, quant):
    """Causal GQA over x (T, d), no position embedding unless
    ``position_embedding_type`` is "rope", scores times
    ``attention_multiplier``; queries ``Q_BLOCK`` at a time."""
    T, d = x.shape
    H, G, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    q = _mm(x, p["wq"].float().reshape(d, -1), quant).view(T, H, hd)
    k = _mm(x, p["wk"].float().reshape(d, -1), quant).view(T, G, hd)
    v = _mm(x, p["wv"].float().reshape(d, -1), quant).view(T, G, hd)
    if cfg.get("position_embedding_type", "rope") == "rope":
        q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    k = k.repeat_interleave(H // G, dim=1)
    v = v.repeat_interleave(H // G, dim=1)
    scale = cfg.get("attention_multiplier") or 1.0 / math.sqrt(hd)
    pos = torch.arange(T, device=x.device)
    ctx = []
    for q0 in range(0, T, Q_BLOCK):
        qb = slice(q0, min(q0 + Q_BLOCK, T))
        s = torch.einsum("thd,shd->hts", q[qb], k) * scale
        s = s.masked_fill(pos[None, qb, None] < pos[None, None, :],
                          float("-inf"))
        ctx.append(torch.einsum("hts,shd->thd", s.softmax(-1), v))
    return _mm(torch.cat(ctx).reshape(T, H * hd),
               p["wo"].float().reshape(H * hd, d), quant)


def _moe(p, x, cfg, quant):
    """The routed experts' sum over x (T, d): the top-k router logits over
    every expert, their softmax as the gates, and each held expert's
    SwiGLU on the tokens that picked it; the shared expert added."""
    k = cfg["num_experts_per_tok"]
    top_v, top_i = _mm(x, p["router"], quant).topk(k, dim=-1)
    gates = top_v.softmax(-1)                               # (T, k)
    y = _mlp(p["shared"], x, quant)
    for e in range(p["w_gate"].shape[0]):
        pick = top_i == e                                   # (T, k)
        tok = pick.any(-1).nonzero()[:, 0]
        if tok.numel() == 0:
            continue
        g = (gates * pick).sum(-1)[tok]
        y[tok] += g[:, None] * _mlp({n: p[n][e] for n in
                                     ("w_gate", "w_up", "w_down")},
                                    x[tok], quant)
    return y


@torch.no_grad()
def logits(w: dict, cfg: dict, seqs: list, starts: list, quant=None) -> list:
    """As ``reference.dense.logits``: for each token list, the float32
    logits (T - start, V) at positions start .. T - 1."""
    eps = cfg.get("norm_eps", 1e-5)
    rm = cfg.get("residual_multiplier", 1.0)
    dev = w["embed"].device
    hs = [w["embed"][torch.as_tensor(s, device=dev)].float()
          * cfg.get("embedding_multiplier", 1.0) for s in seqs]
    for kind, lp in zip(cfg["layer_types"], w["layers"]):
        mixer = _mamba if kind == "mamba" else _attention
        mp = lp["mamba" if kind == "mamba" else "attn"]
        m32 = {n: t.float() for n, t in mp.items()}
        e32 = {n: t.float() for n, t in lp["moe"].items() if n != "shared"}
        e32["shared"] = {n: t.float() for n, t in lp["moe"]["shared"].items()}
        for i, h in enumerate(hs):
            x = rms_norm(h, lp["norm"].float(), eps)
            h = h + rm * mixer(m32, x, cfg, quant)
            x = rms_norm(h, lp["ffn_norm"].float(), eps)
            hs[i] = h + rm * _moe(e32, x, cfg, quant)
        del m32, e32
    head = w["embed"].float().T
    out = []
    for h, s0 in zip(hs, starts):
        x = rms_norm(h[s0:], w["final_norm"].float(), eps)
        out.append(_mm(x, head, quant) / cfg.get("logits_scaling", 1.0))
    return out
