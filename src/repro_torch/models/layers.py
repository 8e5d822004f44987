"""Shared layer primitives: norms, initializers, RoPE, activations
(the port of ``repro.models.layers``)."""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map


def he_init(gen: torch.Generator, shape, dtype, fan_in=None,
            device=None) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights drawn from ``gen`` (on ``gen``'s device
    unless ``device`` is given)."""
    fan_in = fan_in or shape[0]
    w = torch.randn(shape, generator=gen, device=device or gen.device)
    # in place: a full-width expert stack is tens of GB in f32
    return w.div_(math.sqrt(fan_in)).to(dtype)


def _rms_norm(x, scale, eps):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def _layer_norm(x, scale, bias, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _by_rows(fn, x, *params):
    """``fn(x, *params)`` for a norm over x's last dim of a DTensor ``x``:
    whole along that dim, it is normalized block by block (``per_shard``,
    the params whole); split there, by DTensor's own rules."""
    if any(p.is_shard(x.ndim - 1) for p in x.placements):
        return fn(x, *params)
    lead = tuple(range(x.ndim - 1))
    return per_shard(fn, (x,) + params,
                     [lead] + [(None,) * len(lead)] * len(params))


def rms_norm(x, scale, eps=1e-5):
    """RMS norm with a zero-centred scale: ``x / rms(x) * (1 + scale)``."""
    if isinstance(x, DTensor):
        return _by_rows(functools.partial(_rms_norm, eps=eps), x, scale)
    return _rms_norm(x, scale, eps)


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm over the last axis in f32, the result in x's dtype."""
    if isinstance(x, DTensor):
        return _by_rows(functools.partial(_layer_norm, eps=eps), x, scale,
                        bias)
    return _layer_norm(x, scale, bias, eps)


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



class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: a block's
    gradient goes back into DTensor code, whose local views assume it."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def per_shard(fn, xs, axes, *args, mutates=(), out_axes=None):
    """``fn(*xs, *args)`` for an ``fn`` that is independent along some
    logical axes of its inputs (batch rows and kv-head groups for
    attention; batch rows and heads for an SSM step). ``axes`` names, for
    each tensor of ``xs``, the dim that holds each logical axis (None
    where it has none); one tuple of dims serves every tensor alike, a dim
    past a tensor's rank meaning none. Plain tensors: one call. DTensors:
    ``local_map`` with the placements this works out -- the logical axes
    split as the first DTensor of ``xs`` splits them, any other placement
    made whole -- so each rank calls ``fn`` on its blocks, and the result
    is split the same way: the layout the reference's GSPMD gives such an
    op. DTensor finds that layout for a batched product itself, but its
    search over a 5-D product's placements took seconds a call, and some
    of its layouts after a reshape have no rule. ``out_axes``: None for
    one tensor result laid out as the first DTensor; else a list of dims
    tuples, one a tensor of a tuple result (empty: ``fn`` returns nothing
    kept). ``fn`` may write into the blocks of the ``xs`` at the indices
    ``mutates``, which must already lie so (a redistributed copy would
    take the write)."""
    if not any(isinstance(x, DTensor) for x in xs):
        return fn(*xs, *args)
    if not isinstance(axes[0], (tuple, list)):
        axes = [tuple(d if d < x.ndim else None for d in axes) for x in xs]
    first = next(i for i, x in enumerate(xs) if isinstance(x, DTensor))
    mesh = xs[first].device_mesh
    # the logical axis each mesh dim splits, or None
    split = [axes[first].index(p.dim) if p.is_shard()
             and p.dim in axes[first] else None
             for p in xs[first].placements]

    def layout(dims):
        return tuple(Shard(dims[k]) if k is not None and dims[k] is not None
                     else Replicate() for k in split)

    xs = [x if isinstance(x, DTensor) else
          DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim) for x in xs]
    lays = [layout(dims) for dims in axes]
    for i in mutates:
        if tuple(xs[i].placements) != lays[i]:
            raise ValueError(f"per_shard: argument {i} is written in place "
                             f"but lies as {xs[i].placements}, not {lays[i]}")
    # a block whole over a mesh dim that splits another input's axis gets a
    # different gradient on each rank there: a partial sum
    grads = [tuple(Partial() if k is not None and dims[k] is None else p
                   for k, p in zip(split, lay))
             for dims, lay in zip(axes, lays)]
    outs = (layout(axes[first]),) if out_axes is None \
        else tuple(layout(a) for a in out_axes)

    def blocks(*local):
        out = fn(*(_ContiguousGrad.apply(t) if t.requires_grad else t
                   for t in local), *args)
        if out_axes is None:
            return out.contiguous()
        return tuple(o.contiguous() for o in out) if out_axes else ()
    return local_map(blocks, out_placements=outs, in_placements=lays,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*xs)


def fresh_state(init, like, shard_fn, *args):
    """A fresh serve state beside the activations ``like``: ``init(*args,
    device=like.device)``; for a DTensor ``like``, ``init`` gives the
    leaves' shapes on ``meta`` and ``shard_fn(state, "serve_state")``
    lays them out (``sharding.make_shard_fn``: zeros by the plan's
    serve-state rule, each rank making only its blocks)."""
    if not isinstance(like, DTensor):
        return init(*args, device=like.device)
    if shard_fn is None:
        raise ValueError("a sharded prefill lays out its state by shard_fn")
    return shard_fn(init(*args, device="meta"), "serve_state")


def _take(idx, table):
    return table[idx]


def lookup(table, idx):
    """Rows ``idx`` of ``table`` (an embedding lookup, ``table[idx]``).
    With DTensors each rank looks its own block of ``idx`` (split over the
    batch's axes) up in the whole table, gathered on every rank (one
    all-gather of the table; the backward reduce-scatters its gradient, a
    partial sum over the batch's axes, back to the table's layout):
    DTensor's own lookup over a vocab-sharded table takes a masked-partial
    path that fails, and over a gathered one it gathered the indices too."""
    return per_shard(_take, (idx, table), [(0,), (None,)])


def whole_last_dim(x):
    """``x`` with its last dim gathered whole on every rank when it is a
    DTensor split there (vocab-sharded logits before the CE's target
    gather and logsumexp); any other tensor as it is. The backward keeps
    each rank's slice of the gradient, which every rank of the split axes
    computed in full."""
    if not isinstance(x, DTensor):
        return x
    last = x.ndim - 1
    want = [Replicate() if p.is_shard(last) else p for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def token_nll(logits, targets, vocab_logical: int):
    """Per-position NLL (...) in f32 of ``logits`` (..., V_phys) at
    ``targets`` (...); padded vocab columns (past ``vocab_logical``) are
    set to -1e9, as the reference does."""
    logits = whole_last_dim(logits).float()
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
