"""Shared layer primitives: norms, initializers, RoPE, activations
(the port of ``repro.models.layers``)."""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def he_init(gen: torch.Generator, shape, dtype, fan_in=None,
            device=None) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights drawn from ``gen`` (on ``gen``'s device
    unless ``device`` is given)."""
    fan_in = fan_in or shape[0]
    w = torch.randn(shape, generator=gen, device=device or gen.device)
    # in place: a full-width expert stack is tens of GB in f32
    return w.div_(math.sqrt(fan_in)).to(dtype)


def rms_norm(x, scale, eps=1e-5):
    """RMS norm with a zero-centred scale: ``x / rms(x) * (1 + scale)``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm over the last axis in f32, the result in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def silu(x):
    return x * torch.sigmoid(x)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def softplus(x):
    return F.softplus(x)


# ----------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """(head_dim//2,) inverse frequencies, computed in numpy float32 exactly
    as the reference does."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float,
                   device: torch.device) -> torch.Tensor:
    # one host-to-device copy per (head_dim, theta, device): a copy from
    # pageable memory on every call would synchronise the stream twice per
    # layer and serialise the host with the card
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x, positions, theta: float):
    """x: (B, S, heads..., head_dim) rotated by ``positions``: (S,) shared
    across the batch or (B, S) per sequence. Rotate-half convention with
    f32 angles."""
    freqs = _rope_freqs_on(x.shape[-1], float(theta), x.device)
    angles = positions[..., None].float() * freqs            # (..., S, hd/2)
    for _ in range(x.dim() - 3):
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n_pos: int, d_model: int) -> np.ndarray:
    """Whisper-style sinusoidal embeddings (n_pos, d_model), numpy f32: the
    reference's formula."""
    log_timescale = np.log(10_000.0) / (d_model // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(d_model // 2, dtype=np.float32))
    scaled = np.arange(n_pos, dtype=np.float32)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1)


@functools.lru_cache(maxsize=None)
def sinusoidal_positions_on(n_pos: int, d_model: int,
                            device: torch.device) -> torch.Tensor:
    """``sinusoidal_positions`` as an f32 tensor on ``device``, copied once
    per (shape, device), as ``_rope_freqs_on`` is."""
    return torch.from_numpy(sinusoidal_positions(n_pos, d_model)).to(device)



def token_nll(logits, targets, vocab_logical: int):
    """Per-position NLL (...) in f32 of ``logits`` (..., V_phys) at
    ``targets`` (...); padded vocab columns (past ``vocab_logical``) are
    set to -1e9, as the reference does."""
    logits = logits.float()
    if logits.shape[-1] > vocab_logical:
        logits = torch.cat([logits[..., :vocab_logical], torch.full_like(
            logits[..., vocab_logical:], -1e9)], dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def cross_entropy(logits, targets, vocab_logical: int, mask=None):
    """Mean CE over non-masked positions (``mask`` (...) float or bool);
    padded vocab columns are excluded."""
    nll = token_nll(logits, targets, vocab_logical)
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
