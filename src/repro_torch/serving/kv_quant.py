"""Int8 KV-cache quantization, per-token and per-head scales (the port of
``repro.serving.kv_quant``).

A write quantizes each new (token, head) K/V vector to int8 with an f32
absmax scale (absmax / 127, and 1.0 for an all-zero vector); a read
dequantizes it (int8 * scale). Decode is bound by the bytes of the cache it
reads, and the int8 pool is a quarter of an f32 pool's bytes and about half
of a bf16 pool's. On the serve path the read is ``ops.flash_decode`` over
the int8 leaves, which dequantizes in the kernel's loads, so the HBM stream
is the int8 bytes and the scales; ``decode_attend_quant`` below is the
reference's dense read (dequantize the whole pool, then attend), kept as
its oracle.

Rounding: ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.models.layers import HeadBlocks


def quantize(x: torch.Tensor, axis: int = -1) -> tuple:
    """x: (..., d) -> (int8 values, f32 scales with ``axis`` reduced). A
    head-split cache (``layers.HeadBlocks``, split on another axis than
    ``axis``) is quantized block by block, its results split alike."""
    if isinstance(x, HeadBlocks):
        return x.map(lambda t: quantize(t, axis))
    xf = x.float()
    absmax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.squeeze(axis)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               axis: int = -1) -> torch.Tensor:
    return q.float() * scale.unsqueeze(axis)


def init_quant_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                        device="cuda") -> dict:
    """The quantized analogue of one layer's KV cache, on ``device``
    (raises when CUDA is asked for and absent)."""
    device = resolve_device(device)
    shape = (batch, max_len, n_kv)
    return {
        "k_q": torch.zeros(shape + (head_dim,), dtype=torch.int8,
                           device=device),
        "v_q": torch.zeros(shape + (head_dim,), dtype=torch.int8,
                           device=device),
        "k_s": torch.ones(shape, dtype=torch.float32, device=device),
        "v_s": torch.ones(shape, dtype=torch.float32, device=device),
    }


def write_kv_quant(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                   pos, rows=None) -> dict:
    """Write one token's k/v (B, 1, G, d) into ``cache`` in place: row b at
    pos[b] ((B,) int tensor) or all rows at the int ``pos``. ``rows`` (an
    int index tensor) limits the write to those rows (the fleet's
    non-stepping rows keep their cache bit for bit)."""
    kq, ks = quantize(k_new[:, 0])
    vq, vs = quantize(v_new[:, 0])
    if isinstance(pos, int):
        for name, val in (("k_q", kq), ("v_q", vq), ("k_s", ks),
                          ("v_s", vs)):
            cache[name][:, pos] = val
        return cache
    if rows is None:
        rows = torch.arange(kq.shape[0], device=kq.device)
    else:
        kq, ks, vq, vs = kq[rows], ks[rows], vq[rows], vs[rows]
    idx = pos[rows].long().clamp(max=cache["k_q"].shape[1] - 1)  # as write_kv
    for name, val in (("k_q", kq), ("v_q", vq), ("k_s", ks), ("v_s", vs)):
        cache[name][rows, idx] = val
    return cache


def decode_attend_quant(q: torch.Tensor, cache: dict, pos) -> torch.Tensor:
    """Single-token GQA attention over the quantized cache, the reference's
    dense way: dequantize K/V whole, then attend cache[0..pos]. q:
    (B, G, qpg, d); pos: an int or (B,). Returns (B, G, qpg, d)."""
    k = dequantize(cache["k_q"], cache["k_s"])      # (B, S, G, d) f32
    v = dequantize(cache["v_q"], cache["v_s"])
    d = q.shape[-1]
    s = torch.einsum("bgqh,btgh->bgqt", q.float(), k) / math.sqrt(d)
    pos = torch.as_tensor(pos, device=q.device).reshape(-1)
    mask = torch.arange(k.shape[1], device=q.device)[None, :] <= pos[:, None]
    s = torch.where(mask[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bgqt,btgh->bgqh", p, v).to(q.dtype)
