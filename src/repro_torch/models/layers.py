"""Shared layer primitives: norms, initializers, RoPE, activations
(the port of ``repro.models.layers``)."""
from __future__ import annotations

import contextlib
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


class HeadBlocks:
    """One serve-state leaf of a fleet group over a mesh whose ``model``
    axis is larger than 1 (``sharding.HeadLayout``): ``parts[i]``, on its
    own device (the ``model`` axis's i-th), holds the indices ``bounds[i]
    = (lo, hi)`` of dim ``dim`` -- the kv heads of an attention cache, the
    heads of an SSM state, the channels of a conv window. A leaf that the
    axis does not divide is whole on every device (each bound the full
    dim), as the reference replicates it. ``parts[0]``'s device is the
    lead, where the work that is not split runs.

    It is no tensor: indexing that leaves ``dim`` whole (a layer, rows,
    positions) gives the blocks' views, ``copy_`` and item assignment
    write each block its range of the value, and compute on it goes
    through ``per_shard``, which runs a function on each block on the
    block's device."""

    def __init__(self, parts, dim: int, bounds):
        self.parts = list(parts)
        self.dim = int(dim)
        self.bounds = [tuple(b) for b in bounds]

    @property
    def size(self) -> int:
        """The full extent of ``dim``."""
        return max(hi for _, hi in self.bounds)

    @property
    def whole(self) -> bool:
        return all(b == (0, self.size) for b in self.bounds)

    @property
    def shape(self) -> tuple:
        s = list(self.parts[0].shape)
        s[self.dim] = self.size
        return tuple(s)

    @property
    def ndim(self) -> int:
        return self.parts[0].ndim

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        """The lead device."""
        return self.parts[0].device

    def _key(self, key, device) -> tuple:
        """``key`` with its index tensors on ``device``, and where ``dim``
        lands after it. An int, a slice or one 1-D index tensor a dim;
        ``dim`` itself only as ``:``."""
        key = key if isinstance(key, tuple) else (key,)
        if sum(isinstance(k, torch.Tensor) for k in key) > 1:
            raise IndexError("HeadBlocks takes one index tensor at most")
        if len(key) > self.dim and not (isinstance(key[self.dim], slice)
                                        and key[self.dim] == slice(None)):
            raise IndexError(f"HeadBlocks: dim {self.dim} is split; index "
                             f"it through per_shard")
        moved = tuple(k.to(device) if isinstance(k, torch.Tensor) else k
                      for k in key)
        return moved, self.dim - sum(isinstance(k, int)
                                     for k in key[:self.dim])

    def __getitem__(self, key):
        parts, dim = [], self.dim
        for p in self.parts:
            k, dim = self._key(key, p.device)
            parts.append(p[k])
        return HeadBlocks(parts, dim, self.bounds)

    def piece(self, value, i: int, dim: int):
        """Block ``i``'s range of ``value`` (a number, a tensor laid along
        ``dim`` or a HeadBlocks) on block ``i``'s device."""
        if not isinstance(value, (torch.Tensor, HeadBlocks)):
            return value
        lo, hi = self.bounds[i]
        dev = self.parts[i].device
        if isinstance(value, HeadBlocks):
            return value.take(lo, hi, dev)
        if hi - lo != value.shape[dim]:
            value = value.narrow(dim, lo, hi - lo)
        return value.to(dev)

    def __setitem__(self, key, value):
        for i, p in enumerate(self.parts):
            k, dim = self._key(key, p.device)
            p[k] = self.piece(value, i, dim)

    def copy_(self, src):
        for i, p in enumerate(self.parts):
            p.copy_(self.piece(src, i, self.dim))
        return self

    def take(self, lo: int, hi: int, device) -> torch.Tensor:
        """Indices [lo, hi) of ``dim`` on ``device``: from one block that
        holds them (one on ``device`` first), else joined from the blocks
        in order."""
        device = torch.device(device)
        holders = [(p, b) for p, b in zip(self.parts, self.bounds)
                   if b[0] <= lo and hi <= b[1]]
        if holders:
            p, (plo, phi) = next(
                (h for h in holders if h[0].device == device), holders[0])
            if (plo, phi) != (lo, hi):
                p = p.narrow(self.dim, lo - plo, hi - lo)
            return p.to(device)
        pieces, at = [], lo
        for p, (plo, phi) in sorted(zip(self.parts, self.bounds),
                                    key=lambda x: x[1]):
            if plo <= at < phi:
                end = min(phi, hi)
                pieces.append(p.narrow(self.dim, at - plo, end - at)
                              .to(device))
                at = end
        if at != hi:
            raise ValueError(f"HeadBlocks {self.bounds} do not cover "
                             f"[{lo}, {hi})")
        return torch.cat(pieces, dim=self.dim)

    def gather(self, device=None) -> torch.Tensor:
        """The whole leaf on ``device`` (the lead's by default)."""
        return self.take(0, self.size, device or self.device)

    def map(self, fn):
        """``fn`` on each block (an op that keeps ``dim``'s blocks
        independent, such as a per-head quantizer): its results as
        HeadBlocks, a tuple of them for a tuple result."""
        outs = []
        for p in self.parts:
            with _on_device(p.device):
                o = fn(p)
            outs.append(o if isinstance(o, tuple) else (o,))
        res = tuple(HeadBlocks(o, self.dim, self.bounds) for o in zip(*outs))
        return res if len(res) > 1 else res[0]


def _on_device(device: torch.device):
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _per_block(fn, xs, axes, args, over, out_axes):
    """``per_shard`` over HeadBlocks: ``fn`` once a block of ``over`` (the
    first HeadBlocks of ``xs`` when None), on the block's device. A
    HeadBlocks splits the call's LAST logical axis: a plain tensor gives
    each block its range of that axis's dim (the whole tensor where the
    axis is not its, or the layout is whole), another HeadBlocks its
    block. The results join on the lead device along their dims of that
    axis (``out_axes`` as in ``per_shard``; None: one tensor laid out as
    ``xs[0]``); a whole layout's results are its lead block's, every
    block having computed them."""
    lay = over if isinstance(over, HeadBlocks) else \
        next(x for x in xs if isinstance(x, HeadBlocks))
    outs = []
    for i, part in enumerate(lay.parts):
        local = []
        for x, dims in zip(xs, axes):
            d = dims[-1] if dims else None
            if isinstance(x, HeadBlocks):
                same = x.bounds == lay.bounds and \
                    x.parts[i].device == part.device
                local.append(x.parts[i] if same else lay.piece(x, i, x.dim))
            elif isinstance(x, torch.Tensor) and d is not None:
                t = lay.piece(x, i, d)
                local.append(t if t.is_contiguous() else t.contiguous())
            elif isinstance(x, torch.Tensor):
                local.append(x.to(part.device))
            else:
                local.append(x)
        with _on_device(part.device):
            outs.append(fn(*local, *args))
    if out_axes is not None and not out_axes:
        return None
    if lay.whole:
        return outs[0]
    lead = lay.device

    def join(parts, dims):
        if parts[0] is None:
            return None
        return torch.cat([p.to(lead) for p in parts], dim=dims[-1])
    if out_axes is None:
        return join(outs, axes[0])
    return tuple(join(ps, dims) for ps, dims in zip(zip(*outs), out_axes))


def per_shard(fn, xs, axes, *args, mutates=(), out_axes=None, over=None,
              blocks_only=False):
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
    take the write).

    HeadBlocks (a fleet group's head-split state, ``over`` or the first
    of ``xs``): ``fn`` runs once a block, on the block's device, over the
    call's last logical axis (``_per_block``); ``xs`` may then hold None,
    passed as it is. ``over`` names the state whose layout a call over
    plain tensors follows (a prefill's attention, which reads the
    projected K/V rather than the cache they are written to); a plain or
    DTensor ``over`` changes nothing. ``blocks_only``: DTensors call
    ``fn`` whole, under DTensor's own propagation, as plain tensors do
    (a site that only a fleet group's head split runs block by block)."""
    blocks = isinstance(over, HeadBlocks) or any(isinstance(x, HeadBlocks)
                                                 for x in xs)
    if not blocks and (blocks_only
                       or not any(isinstance(x, DTensor) for x in xs)):
        return fn(*xs, *args)
    if not isinstance(axes[0], (tuple, list)):
        axes = [tuple(d if x is not None and d < x.ndim else None
                      for d in axes) for x in xs]
    if blocks:
        return _per_block(fn, xs, axes, args, over, out_axes)
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
    serve-state rule, each rank making only its blocks); so does a fleet
    group's head layout (``sharding.HeadLayout``, whose ``lays_out_blocks``
    is set: HeadBlocks on its ``model`` devices) for a plain ``like``."""
    if not isinstance(like, DTensor) \
            and not getattr(shard_fn, "lays_out_blocks", False):
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
