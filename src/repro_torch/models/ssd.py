"""Mamba-2 (SSD -- state-space duality) block: chunked scan + O(1) decode
(the port of ``repro.models.ssd``).

Recurrence (per head h, state (P, N)):
    s_t = exp(dt_t * A_h) * s_{t-1} + dt_t * B_t (x) x_t
    y_t = C_t . s_t + D_h * x_t

Two backends compute the prefill scan:

  * ``"pallas"`` (default) -- ``ops.ssd_scan``: the hand-written CUDA
    kernel on a CUDA tensor, its plain version on a CPU tensor;
  * ``"einsum"`` -- ``ssd_chunked``, the reference's blocked scan written
    as dense tensor code, kept as the oracle.

A chunked prefill continues the scan from the carried state
(``init_state``, the kernel's too) and the convolution from the carried
raw window (``conv_state``), so chunk by chunk equals the single-shot
forward.

Decode (``mamba2_decode``) is one recurrence step of the carried state, in
place (the reference returns a new state and relies on jit buffer
donation; eagerly that would copy every layer's state on every step):
``ops.ssd_decode``, the hand-written kernel, on ``"pallas"``; its plain
version ``ref.ssd_decode_ref`` on ``"einsum"``. The conv step, the skip
term and the gate are PyTorch on both.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ops, ref
from repro_torch.models.layers import (HeadBlocks, he_init, per_shard,
                                       rms_norm, silu, softplus)


# --------------------------------------------------------------------- params
def init_mamba2(gen: torch.Generator, d_model: int, d_inner: int,
                n_heads: int, head_dim: int, d_state: int, n_groups: int,
                conv_width: int, dtype) -> dict:
    """Random weights from ``gen``; A_log and dt_bias are the reference's
    own numpy draws (mamba2's default init: A in [1, 16], dt in
    [1e-3, 1e-1])."""
    dev = gen.device
    d_in_proj = 2 * d_inner + 2 * n_groups * d_state + n_heads  # z, xBC, dt
    conv_ch = d_inner + 2 * n_groups * d_state
    a = np.random.RandomState(0).uniform(1.0, 16.0, (n_heads,))
    dt = np.exp(np.random.RandomState(1).uniform(np.log(1e-3), np.log(1e-1),
                                                 (n_heads,)))
    dt_bias = dt + np.log(-np.expm1(-dt))  # inverse softplus
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": he_init(gen, (d_model, d_in_proj), dtype, d_model),
        "conv_w": he_init(gen, (conv_width, conv_ch), dtype, conv_width),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "out_proj": he_init(gen, (d_inner, d_model), dtype, d_inner),
        "A_log": torch.tensor(np.log(a), **f32),
        "D": torch.ones((n_heads,), **f32),
        "dt_bias": torch.tensor(dt_bias, **f32),
        "norm_scale": torch.zeros((d_inner,), **f32),
    }


# ----------------------------------------------------------------- core math
def segsum_exp(a):
    """a: (..., Q) log decays -> L (..., Q, Q) with L[q, k] =
    exp(sum_{k+1..q} a), lower-triangular (diagonal 1).

    The upper triangle is masked before the exp, not after it as in the
    reference: there diff = -(decay over k..q) > 0 overflows exp to inf
    once a chunk's decay passes ~88 (mamba2's chunk of 256 does), and the
    backward of where(tri, inf, 0) is 0 x inf = NaN in every gradient.
    The values are the same (exp(-inf) = 0)."""
    a_cum = torch.cumsum(a, dim=-1)
    diff = a_cum[..., :, None] - a_cum[..., None, :]
    Q = a.shape[-1]
    tri = torch.ones(Q, Q, dtype=torch.bool, device=a.device).tril()
    return torch.exp(torch.where(tri, diff, float("-inf")))


def _pad_steps(t, pad: int):
    """Zero-pad axis 1 (time) of ``t`` by ``pad`` steps at the end."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """The reference's blocked SSD scan from ``init_state`` (B, H, P, N),
    zeros when None. x: (B, T, H, P) inputs (not yet dt-weighted); dt:
    (B, T, H) step sizes; A: (H,) negative rates; Bm, Cm: (B, T, G, N)
    with H % G == 0. Returns (y (B, T, H, P) f32, final state
    (B, H, P, N) f32)."""
    Bsz, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    T_orig = T
    if T % chunk:
        # padded steps have dt = 0 -> decay 1 and zero input: inert
        pad = chunk - T % chunk
        x, dt, Bm, Cm = (_pad_steps(t, pad) for t in (x, dt, Bm, Cm))
        T += pad
    nc, rep = T // chunk, H // G
    a = (dt * A[None, None, :]).float()                     # (B, T, H)
    xdt = (x * dt[..., None]).float()
    Bf, Cf = Bm.float(), Cm.float()
    state = torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                        device=x.device) if init_state is None \
        else init_state.float()
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc, ac = xdt[:, sl], a[:, sl]
        bh = ref.per_head(Bf[:, sl], rep, 2)                 # (B, Q, H, N)
        ch = ref.per_head(Cf[:, sl], rep, 2)
        a_cum = torch.cumsum(ac, dim=1)                      # (B, Q, H)
        L = segsum_exp(ac.transpose(1, 2))                   # (B, H, Q, Q)
        scores = torch.einsum("bqhn,bkhn->bhqk", ch, bh)
        y_diag = torch.einsum("bhqk,bkhp->bqhp", L * scores, xc)
        y_off = torch.einsum("bqhn,bhpn->bqhp", ch, state) \
            * torch.exp(a_cum)[..., None]
        decay_out = torch.exp(a_cum[:, -1:, :] - a_cum)      # (B, Q, H)
        state = state * torch.exp(a_cum[:, -1])[:, :, None, None] + \
            torch.einsum("bkhn,bkhp->bhpn", bh, xc * decay_out[..., None])
        ys.append(y_diag + y_off)
    return torch.cat(ys, dim=1)[:, :T_orig], state


def ssd_decode_step(state, x, dt, A, Bm, Cm, rows=None, backend="pallas"):
    """One token. state: (B, H, P, N) f32, updated in place (only rows
    ``rows``, an int index tensor, when given: the others keep their state
    bit for bit); x: (B, H, P), dt: (B, H), Bm/Cm: (B, G, N). ``backend``
    ``"pallas"`` steps through ``ops.ssd_decode``, ``"einsum"`` through
    its plain version. Returns (y (B, H, P) f32, state). A DTensor state
    (batch over data, heads over model) is stepped block by block on each
    rank, every row; a head-split state (``layers.HeadBlocks``) block by
    block on each device, ``rows`` too."""
    steps = {"pallas": _kernel_step, "einsum": _decode_step}
    if backend not in steps:
        raise ValueError(f"unknown attention backend {backend!r}")
    step = steps[backend]
    if isinstance(state, (DTensor, HeadBlocks)):
        if rows is not None and isinstance(state, DTensor):
            raise ValueError("a sharded state is stepped whole: rows=None")
        # batch rows and heads are independent (B/C follow the batch)
        xs = (state, x, dt, A, Bm, Cm) + (() if rows is None else (rows,))
        y = per_shard(lambda *a: step(*a)[0], xs,
                      [(0, 1), (0, 1), (0, 1), (None, 0), (0, None),
                       (0, None), (None, None)][:len(xs)], mutates=(0,))
        return y, state
    return step(state, x, dt, A, Bm, Cm, rows)


def _decode_step(state, x, dt, A, Bm, Cm, rows=None):
    """The plain step: (y, state)."""
    return ref.ssd_decode_ref(state, x, dt, A, Bm, Cm, rows), state


def _kernel_step(state, x, dt, A, Bm, Cm, rows=None):
    return ops.ssd_decode(state, x, dt, A, Bm, Cm, write=rows), state


# -------------------------------------------------------------- full block
def causal_conv(x, w, b, left=None):
    """Depthwise causal conv. x: (B, T, C); w: (W, C). ``left``
    (B, W - 1, C) is the raw window carried from a previous chunk; None is
    a fresh sequence (zero left context)."""
    W, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0)) if left is None \
        else torch.cat([left.to(x.dtype), x], dim=1)
    out = xp[:, 0:T] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + T] * w[i]
    return out + b


def _split_proj(proj, cfg):
    d_inner, N, G = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    return (proj[..., :d_inner], proj[..., d_inner:2 * d_inner + 2 * G * N],
            proj[..., -cfg.ssm_heads:])


def _gate_out(params, y, xh, z, cfg, dtype):
    """Skip term, gate, norm and out-projection (torch on every backend)."""
    y = y + xh.float() * params["D"][:, None]
    y = y.reshape(*z.shape).to(dtype)
    return rms_norm(y * silu(z), params["norm_scale"], cfg.norm_eps) \
        @ params["out_proj"]


def _ssd_kernel_path(xh, dt, A, Bm, Cm, chunk: int, init_state=None):
    """The scan through ``ops.ssd_scan`` from ``init_state`` (zeros when
    None): dt-weighted x and the log decays in f32, B/C of the single
    group, T zero-padded (dt = 0, inert) to a multiple of min(chunk, T) as
    the TPU kernel asks."""
    if Bm.shape[2] != 1:
        raise NotImplementedError(f"ssd_scan with {Bm.shape[2]} B/C groups "
                                  "is not yet ported (one group only)")
    T = xh.shape[1]
    q = min(chunk, T)
    pad = -T % q
    a = (dt * A[None, None, :]).float()
    xdt = (xh * dt[..., None]).float()
    Bs, Cs = Bm[:, :, 0].float(), Cm[:, :, 0].float()
    if pad:
        xdt, a, Bs, Cs = (_pad_steps(t, pad) for t in (xdt, a, Bs, Cs))
    if init_state is not None:
        init_state = init_state.float().contiguous()
    y, state = ops.ssd_scan(xdt.contiguous(), a.contiguous(),
                            Bs.contiguous(), Cs.contiguous(), chunk=q,
                            init_state=init_state)
    return y[:, :T], state


def _conv_and_tail(x, w, b, left, lengths, W: int, tail: bool):
    """``causal_conv`` of the raw ``x`` (B, T, C) from the carried window
    ``left``, and with ``tail`` the next decode window (B, W - 1, C): the
    last W - 1 real raw rows of [left | x] (``lengths`` (B,) real rows of
    a right-padded x), zeros before a fresh prompt's start. Both are per
    channel. Returns (conv output, window or None)."""
    out = causal_conv(x, w, b, left=left)
    if not tail:
        return out, None
    if left is not None:
        # the cumulative raw sequence is [carry | chunk], so the next window
        # is its last W - 1 real rows, always in bounds (the carry supplies
        # the left context even for a chunk shorter than the window)
        window = torch.cat([left.to(x.dtype), x], dim=1)
        if lengths is None:
            return out, window[:, -(W - 1):]
        idx = lengths[:, None].long() + torch.arange(
            W - 1, device=x.device)[None, :]                     # (B, W-1)
        return out, torch.gather(
            window, 1, idx[:, :, None].expand(-1, -1, window.shape[-1]))
    if lengths is None:
        conv_tail = x[:, -(W - 1):]             # raw window for decode conv
        if conv_tail.shape[1] < W - 1:          # prompt shorter than window
            conv_tail = F.pad(conv_tail, (0, 0, W - 1 - conv_tail.shape[1], 0))
        return out, conv_tail
    offs = torch.arange(-(W - 1), 0, dtype=torch.int32, device=x.device)
    idx = lengths[:, None].to(torch.int32) + offs[None, :]       # (B, W-1)
    gathered = torch.gather(
        x, 1, idx.clamp(min=0).long()[:, :, None].expand(-1, -1, x.shape[-1]))
    return out, torch.where((idx >= 0)[:, :, None], gathered, 0.0)


def _scan(xh, dt, A, Bm, Cm, init_state, backend: str, chunk: int):
    """The prefill scan on ``backend``: (y, final state)."""
    if backend == "pallas":
        return _ssd_kernel_path(xh, dt, A, Bm, Cm, chunk, init_state)
    if backend == "einsum":
        return ssd_chunked(xh, dt, A, Bm, Cm, chunk, init_state)
    raise ValueError(f"unknown attention backend {backend!r}")


def mamba2_forward(params, x, cfg, *, init_state=None, conv_state=None,
                   return_state=False, lengths=None,
                   attn_backend: str = "pallas", over=None):
    """Full-sequence Mamba-2 block. x: (B, T, d_model).

    ``lengths`` (B,) marks the true length of each right-padded row:
    padded steps get dt = 0 (decay 1, zero input: exactly inert), and the
    decode conv state is gathered from the last ``conv_width - 1`` real
    positions, so the returned state matches an unpadded forward. Both are
    device operations; no host value is read back.

    ``init_state`` / ``conv_state`` continue a sequence from a previous
    chunk (chunked prefill): ``init_state`` (B, H, P, N) seeds the scan and
    ``conv_state`` (B, W - 1, C) is the carried raw conv window (the layout
    the decode path keeps), so a prompt run chunk by chunk reproduces the
    single-shot forward. None is a fresh sequence.

    ``over``: the layer's serve state ({"ssm", "conv"}) the final state
    is written to, when a fleet group splits it over a ``model`` axis
    (``layers.HeadBlocks``): the conv then runs on each of the conv
    state's channel blocks and the scan on each of the SSM state's head
    blocks, each on its device, their outputs joined on the lead device
    (each head block needs x-channels and all of B and C, which do not
    line up with the conv's channel blocks)."""
    N, G = cfg.ssm_state, cfg.ssm_groups
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    Bsz, T = x.shape[:2]
    over = over or {}
    z, xBC_raw, dt_raw = _split_proj(x @ params["in_proj"], cfg)
    conv_out, conv_tail = per_shard(
        _conv_and_tail, (xBC_raw, params["conv_w"], params["conv_b"],
                         conv_state, lengths),
        [(2,), (1,), (0,), (2,), ()], cfg.ssm_conv_width, return_state,
        out_axes=[(2,), (2,)], over=over.get("conv"), blocks_only=True)
    xBC = silu(conv_out)
    d_inner = cfg.d_inner
    xs = xBC[..., :d_inner]
    Bm = xBC[..., d_inner:d_inner + G * N].reshape(Bsz, T, G, N)
    Cm = xBC[..., d_inner + G * N:].reshape(Bsz, T, G, N)
    dt = softplus(dt_raw.float() + params["dt_bias"])
    if lengths is not None:
        tpos = torch.arange(T, dtype=torch.int32, device=x.device)
        dt = torch.where(tpos[None, :, None] < lengths[:, None, None], dt,
                         0.0)
    A = -torch.exp(params["A_log"])
    xh = xs.reshape(Bsz, T, H, P)
    # batch rows and heads are independent (B/C follow the batch)
    y, state = per_shard(
        _scan, (xh, dt, A, Bm, Cm, init_state),
        [(0, 2), (0, 2), (None, 0), (0, None), (0, None), (0, 1)],
        attn_backend, cfg.ssm_chunk, out_axes=[(0, 2), (0, 1)],
        over=over.get("ssm"), blocks_only=True)
    out = _gate_out(params, y, xh, z, cfg, x.dtype)
    if not return_state:
        return out
    return out, {"ssm": state, "conv": conv_tail}


def mamba2_init_state(batch: int, cfg, dtype=torch.float32,
                      device="cuda") -> dict:
    conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
    }


def _conv_step(x_new, conv, w, b, rows=None):
    """One decode step of the depthwise conv over the carried raw window
    ``conv`` (B, W - 1, C), which shifts in ``x_new`` (B, C) in place
    (rows ``rows`` only, when given): the conv's output (B, C)."""
    window = torch.cat([conv, x_new[:, None].to(conv.dtype)], dim=1)
    out = (window * w).sum(dim=1) + b
    if rows is None:
        conv.copy_(window[:, 1:])
    else:
        conv[rows] = window[rows, 1:]
    return out


def mamba2_decode(params, x, cfg, state, rows=None,
                  attn_backend: str = "pallas"):
    """One-token decode. x: (B, 1, d_model); state: {"ssm", "conv"}, both
    updated in place (only rows ``rows``, an int index tensor, when given:
    the other rows keep theirs bit for bit); ``attn_backend`` picks the
    SSM step (``ssd_decode_step``). Returns (out (B, 1, d_model),
    state)."""
    N, G = cfg.ssm_state, cfg.ssm_groups
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    z, xBC_new, dt_raw = _split_proj(x[:, 0] @ params["in_proj"], cfg)
    # per channel: a head-split conv state steps on its channel blocks
    xBC = silu(per_shard(
        _conv_step, (xBC_new, state["conv"], params["conv_w"],
                     params["conv_b"]) + (() if rows is None else (rows,)),
        [(1,), (2,), (1,), (0,), ()], blocks_only=True))
    d_inner = cfg.d_inner
    xs = xBC[..., :d_inner]
    Bm = xBC[..., d_inner:d_inner + G * N].reshape(-1, G, N)
    Cm = xBC[..., d_inner + G * N:].reshape(-1, G, N)
    dt = softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    xh = xs.reshape(-1, H, P)
    # the default backend goes unnamed: the call keeps the step's seven
    # arguments, so a stand-in step of that signature (the one
    # portbench/tests/test_portbench_run.py puts in) still fits
    named = {} if attn_backend == "pallas" else {"backend": attn_backend}
    y, _ = ssd_decode_step(state["ssm"], xh, dt, A, Bm, Cm, rows, **named)
    out = _gate_out(params, y, xh, z, cfg, x.dtype)
    return out[:, None], state
