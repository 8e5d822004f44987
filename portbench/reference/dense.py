"""Plain PyTorch reference of the dense family, in float32.

The port's equations written out again from the configuration, with no
kernel, cache or batching: token embedding (times
``embedding_multiplier``), then per layer a pre-norm RMSNorm with a
zero-centred scale (``x / rms(x) * (1 + w)``), grouped-query attention
with rotate-half RoPE at ``rope_theta`` and the softmax scale
``attention_multiplier``, a SwiGLU MLP, each added to the residual times
``residual_multiplier``; a final RMSNorm and the tied embedding as the
head, divided by ``logits_scaling``. Imports nothing of the program.

``make_weights`` draws the weights the benchmark hands to both sides, in
the layout of the program's parameter tree (``embed`` (V, d),
``final_norm``, ``layers`` [{``attn_norm``, ``attn`` {``wq`` (d, H, hd),
``wk``/``wv`` (d, G, hd), ``wo`` (H, hd, d)}, ``ffn_norm``, ``mlp``
{``w_gate``/``w_up`` (d, F), ``w_down`` (F, d)}}]): one flat buffer of
normal draws made on the device in a few large calls, cut into views and
scaled by 1 / sqrt(fan-in) (the embedding by 0.02, granite's
initializer range); norms are zero.

``logits`` runs whole sequences layer by layer, each layer's weights cast
to float32 once for every sequence. With ``quant="fp8"`` every matrix
product takes its weight and its input rounded to float8 e4m3 (a scale a
tensor for the weight, a row for the input), the step below the served
bfloat16: the control of the comparison.
"""
from __future__ import annotations

import math

import torch

FP8_MAX = 448.0          # the largest finite float8 e4m3 value
CHUNK = 1 << 30          # normal draws a call


def _leaves(cfg: dict) -> list:
    """[(path, shape, fan_in)] of the matrices, in buffer order."""
    d, H, G = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    hd, F, V = cfg["head_dim"], cfg["d_ff"], cfg["vocab_size"]
    out = [(("embed",), (V, d), None)]
    for i in range(cfg["num_layers"]):
        a, m = ("layers", i, "attn"), ("layers", i, "mlp")
        out += [(a + ("wq",), (d, H, hd), d), (a + ("wk",), (d, G, hd), d),
                (a + ("wv",), (d, G, hd), d), (a + ("wo",), (H, hd, d), H * hd),
                (m + ("w_gate",), (d, F), d), (m + ("w_up",), (d, F), d),
                (m + ("w_down",), (F, d), F)]
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
    d = cfg["d_model"]
    zeros = torch.zeros((2 * cfg["num_layers"] + 1, d), dtype=torch.float32,
                        device=device)
    w = {"embed": None, "final_norm": zeros[-1],
         "layers": [{"attn_norm": zeros[2 * i], "ffn_norm": zeros[2 * i + 1],
                     "attn": {}, "mlp": {}}
                    for i in range(cfg["num_layers"])]}
    at = 0
    for path, shape, fan_in in leaves:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        t.mul_(0.02 if fan_in is None else 1.0 / math.sqrt(fan_in))
        at += n
        if path[0] == "embed":
            w["embed"] = t
        else:
            w["layers"][path[1]][path[2]][path[3]] = t
    return w


def _fp8(x: torch.Tensor, dim) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with an absmax scale over ``dim``
    (None: the whole tensor), back in float32."""
    amax = x.abs().amax() if dim is None else x.abs().amax(dim, keepdim=True)
    scale = (amax / FP8_MAX).clamp(min=1e-12)
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(x: torch.Tensor, w: torch.Tensor, quant) -> torch.Tensor:
    if quant == "fp8":
        return _fp8(x, -1) @ _fp8(w, None)
    return x @ w


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1 + w)


def rope(x, theta):
    """Rotate-half RoPE of x (T, heads, hd) at positions 0 .. T - 1."""
    T, hd = x.shape[0], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(p, x, cfg, quant):
    T, d = x.shape
    H, G, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    q = _mm(x, p["wq"].float().reshape(d, -1), quant).view(T, H, hd)
    k = _mm(x, p["wk"].float().reshape(d, -1), quant).view(T, G, hd)
    v = _mm(x, p["wv"].float().reshape(d, -1), quant).view(T, G, hd)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    k = k.repeat_interleave(H // G, dim=1)
    v = v.repeat_interleave(H // G, dim=1)
    s = torch.einsum("thd,shd->hts", q, k) * cfg["attention_multiplier"]
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    ctx = torch.einsum("hts,shd->thd", s.softmax(-1), v).reshape(T, H * hd)
    return _mm(ctx, p["wo"].float().reshape(H * hd, d), quant)


def _mlp(p, x, quant):
    g = _mm(x, p["w_gate"].float(), quant)
    u = _mm(x, p["w_up"].float(), quant)
    return _mm(g * torch.sigmoid(g) * u, p["w_down"].float(), quant)


@torch.no_grad()
def logits(w: dict, cfg: dict, seqs: list, starts: list, quant=None) -> list:
    """For each token list in ``seqs``, the float32 logits (T - start, V)
    at positions start .. T - 1 (each predicts the token after it)."""
    eps = cfg.get("norm_eps", 1e-5)
    rm = cfg.get("residual_multiplier", 1.0)
    dev = w["embed"].device
    hs = [w["embed"][torch.as_tensor(s, device=dev)].float()
          * cfg.get("embedding_multiplier", 1.0) for s in seqs]
    for lp in w["layers"]:
        lp32 = {"attn": {k: v.float() for k, v in lp["attn"].items()},
                "mlp": {k: v.float() for k, v in lp["mlp"].items()}}
        for i, h in enumerate(hs):
            x = rms_norm(h, lp["attn_norm"].float(), eps)
            h = h + rm * _attention(lp32["attn"], x, cfg, quant)
            x = rms_norm(h, lp["ffn_norm"].float(), eps)
            hs[i] = h + rm * _mlp(lp32["mlp"], x, quant)
        del lp32
    head = w["embed"].float().T
    out = []
    for h, s0 in zip(hs, starts):
        x = rms_norm(h[s0:], w["final_norm"].float(), eps)
        out.append(_mm(x, head, quant) / cfg.get("logits_scaling", 1.0))
    return out
