"""Plain PyTorch reference of the ssm family (Mamba-2), in float32.

The port's equations written out again from the configuration, with no
kernel, cache or batching. Per layer, on the pre-normed input x (RMSNorm
with a zero-centred scale): ``in_proj`` splits into the gate z, the raw
x|B|C channels and dt; a depthwise causal conv of width ``ssm_conv_width``
with its bias, then SiLU; dt = softplus(dt + dt_bias), A = -exp(A_log);
per head the SSD recurrence

    s_t = exp(dt_t A) s_{t-1} + dt_t B_t (x) x_t,   y_t = C_t . s_t + D x_t

(one B/C group for all heads), computed here in its quadratic dual form
over the whole sequence, y = (L o C B^T) (dt x) with L[t, s] =
exp(sum_{s < r <= t} dt_r A); then y * SiLU(z), a gated RMSNorm and
``out_proj``, added to the residual. A final RMSNorm and the tied
embedding give the logits. Imports nothing of the program.

``make_weights`` draws the weights the benchmark hands to both sides, in
the layout of the program's parameter tree (``embed``, ``final_norm``,
``layers`` [{``norm``, ``mamba`` {``in_proj`` (d, 2 d_in + 2 N + H),
``conv_w`` (W, d_in + 2 N), ``conv_b``, ``out_proj`` (d_in, d), ``A_log``,
``D``, ``dt_bias``, ``norm_scale``}}]): the matrices from one flat buffer
of normal draws on the device, scaled by 1 / sqrt(fan-in); A from U[1, 16]
and dt from log-uniform [1e-3, 1e-1] (Mamba-2's initialisation), drawn
from the same generator; D one; biases and norms zero. ``quant="fp8"``:
as in ``reference/dense.py``, the control.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.dense import CHUNK, _mm, rms_norm


def _dims(cfg: dict) -> tuple:
    d = cfg["d_model"]
    d_in = cfg["ssm_expand"] * d
    H = d_in // cfg["ssm_head_dim"]
    N, G = cfg["ssm_state"], cfg.get("ssm_groups", 1)
    return d, d_in, H, N, G


def _leaves(cfg: dict) -> list:
    d, d_in, H, N, G = _dims(cfg)
    W = cfg["ssm_conv_width"]
    out = [(("embed",), (cfg["vocab_size"], d), None)]
    for i in range(cfg["num_layers"]):
        m = ("layers", i, "mamba")
        out += [(m + ("in_proj",), (d, 2 * d_in + 2 * G * N + H), d),
                (m + ("conv_w",), (W, d_in + 2 * G * N), W),
                (m + ("out_proj",), (d_in, d), d_in)]
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
    L = cfg["num_layers"]
    f32 = dict(dtype=torch.float32, device=device)
    u = torch.rand((2, L, H), generator=gen, **f32)
    a = 1.0 + 15.0 * u[0]
    dt = torch.exp(math.log(1e-3) + u[1] * (math.log(1e-1) - math.log(1e-3)))
    dt_bias = dt + torch.log(-torch.expm1(-dt))          # inverse softplus
    w = {"embed": None, "final_norm": torch.zeros(d, **f32), "layers": []}
    for i in range(L):
        w["layers"].append({"norm": torch.zeros(d, **f32), "mamba": {
            "conv_b": torch.zeros(d_in + 2 * G * N, dtype=dtype,
                                  device=device),
            "A_log": torch.log(a[i]), "D": torch.ones(H, **f32),
            "dt_bias": dt_bias[i], "norm_scale": torch.zeros(d_in, **f32)}})
    at = 0
    for path, shape, fan_in in leaves:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        t.mul_(0.02 if fan_in is None else 1.0 / math.sqrt(fan_in))
        at += n
        if path[0] == "embed":
            w["embed"] = t
        else:
            w["layers"][path[1]]["mamba"][path[3]] = t
    return w


def _mixer(p, x, cfg, quant):
    """One Mamba-2 block over x (T, d): its output (T, d)."""
    d, d_in, H, N, G = _dims(cfg)
    T, P = x.shape[0], cfg["ssm_head_dim"]
    proj = _mm(x, p["in_proj"].float(), quant)
    z, xbc, dt = proj[:, :d_in], proj[:, d_in:2 * d_in + 2 * G * N], \
        proj[:, 2 * d_in + 2 * G * N:]
    W = p["conv_w"].shape[0]
    xp = F.pad(xbc, (0, 0, W - 1, 0))
    conv = sum(xp[i:i + T] * p["conv_w"][i].float() for i in range(W))
    xbc = F.silu(conv + p["conv_b"].float())
    xs = xbc[:, :d_in].view(T, H, P)
    Bm = xbc[:, d_in:d_in + G * N].view(T, G, N)
    Cm = xbc[:, d_in + G * N:].view(T, G, N)
    Bm = Bm.repeat_interleave(H // G, dim=1)                 # (T, H, N)
    Cm = Cm.repeat_interleave(H // G, dim=1)
    dt = F.softplus(dt + p["dt_bias"])                      # (T, H)
    la = dt * -torch.exp(p["A_log"])                        # log decays
    cum = torch.cumsum(la, dim=0)                           # (T, H)
    seg = (cum[:, None, :] - cum[None, :, :]).permute(2, 0, 1)  # (H, t, s)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    Lm = torch.exp(seg.masked_fill(~causal, float("-inf")))
    cb = torch.einsum("thn,shn->hts", Cm, Bm)
    y = torch.einsum("hts,shp->thp", Lm * cb, xs * dt[..., None])
    y = y + xs * p["D"][:, None]
    y = y.reshape(T, d_in) * F.silu(z)
    y = rms_norm(y, p["norm_scale"], cfg.get("norm_eps", 1e-5))
    return _mm(y, p["out_proj"].float(), quant)


@torch.no_grad()
def logits(w: dict, cfg: dict, seqs: list, starts: list, quant=None) -> list:
    """As ``reference.dense.logits``: for each token list, the float32
    logits (T - start, V) at positions start .. T - 1."""
    eps = cfg.get("norm_eps", 1e-5)
    dev = w["embed"].device
    hs = [w["embed"][torch.as_tensor(s, device=dev)].float() for s in seqs]
    for lp in w["layers"]:
        for i, h in enumerate(hs):
            x = rms_norm(h, lp["norm"], eps)
            hs[i] = h + _mixer(lp["mamba"], x, cfg, quant)
    head = w["embed"].float().T
    out = []
    for h, s0 in zip(hs, starts):
        x = rms_norm(h[s0:], w["final_norm"], eps)
        out.append(_mm(x, head, quant))
    return out
