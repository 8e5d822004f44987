"""Sequence-sharded KV decode attention, merged by log-sum-exp
(``repro.distributed.seq_kv``'s twin).

The cache's SEQUENCE is split over the mesh's ``seq_axis`` devices (and
the batch over ``batch_axes``) with the logical kv heads kept; each shard
computes a partial attention over its positions, and the partials merge by
the flash-decode rule:

    m = max_i m_i;  l = sum_i l_i e^{m_i - m};  acc = sum_i acc_i e^{m_i - m}

and the output is acc / l. The shards' work runs on their devices from one
host loop (``launch.mesh.Mesh`` is single-process); the merge runs on q's
device. The per-shard partial is plain torch, as the reference's is plain
jnp outside any Pallas kernel.
"""
from __future__ import annotations

import math

import numpy as np
import torch

NEG_INF = -1e30


def _local_partial(q, k, v, pos, s_offset: int) -> tuple:
    """Partial decode attention over one sequence shard. q: (B, Hq, d);
    k, v: (B, S_loc, KV, d) at global positions s_offset + t; positions
    past ``pos`` are masked. Returns (m (B, Hq), l (B, Hq), acc (B, Hq,
    d)), in f32."""
    B, Hq, d = q.shape
    rep = Hq // k.shape[2]
    kr = torch.repeat_interleave(k, rep, dim=2).float()     # (B, S, Hq, d)
    vr = torch.repeat_interleave(v, rep, dim=2).float()
    s = torch.einsum("bhd,bthd->bht", q.float(), kr) / math.sqrt(d)
    offs = s_offset + torch.arange(k.shape[1], device=q.device)
    live = (offs <= pos)[None, None, :]
    s = torch.where(live, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(live, torch.exp(s - m[..., None]), 0.0)
    return m, p.sum(dim=-1), torch.einsum("bht,bthd->bhd", p, vr)


def seq_sharded_flash_decode(mesh, q, k_cache, v_cache, pos, *,
                             seq_axis: str = "model",
                             batch_axes=("data",)):
    """q: (B, Hq, d); k_cache, v_cache: (B, S, KV_logical, d); pos: the
    scalar last position attended. The batch splits over the mesh's
    ``batch_axes`` (those present), the sequence over ``seq_axis``; any
    other mesh axis takes index 0. Returns (B, Hq, d) in q's dtype, on q's
    device: attention over cache[0..pos]."""
    B, S = k_cache.shape[:2]
    names = mesh.axis_names
    n = mesh.shape[seq_axis]
    if S % n:
        raise ValueError(f"sequence {S} does not split over {n} shards")
    ba = [a for a in batch_axes if a in names]
    nb = int(np.prod([mesh.shape[a] for a in ba])) if ba else 1
    if B % nb:
        raise ValueError(f"batch {B} does not split over {nb} shards")
    s_loc, b_loc = S // n, B // nb
    pos = int(pos)
    # the devices as (batch block, sequence shard): batch axes first,
    # then the sequence axis, every other axis at index 0
    order = ba + [seq_axis]
    devs = np.moveaxis(mesh.devices, [names.index(a) for a in order],
                       list(range(len(order))))
    devs = devs.reshape((nb, n, -1))[:, :, 0]
    out = []
    for i in range(nb):
        b = slice(i * b_loc, (i + 1) * b_loc)
        parts = []
        for j in range(n):
            dev, s = devs[i, j], slice(j * s_loc, (j + 1) * s_loc)
            part = _local_partial(q[b].to(dev), k_cache[b, s].to(dev),
                                  v_cache[b, s].to(dev), pos, j * s_loc)
            parts.append([t.to(q.device) for t in part])
        m = torch.stack([p[0] for p in parts])              # (n, b, Hq)
        m_g = m.amax(dim=0)
        corr = torch.exp(m - m_g)
        l_g = (torch.stack([p[1] for p in parts]) * corr).sum(dim=0)
        acc = (torch.stack([p[2] for p in parts]) * corr[..., None]).sum(0)
        safe = torch.where(l_g > 0, l_g, torch.ones_like(l_g))
        out.append((acc / safe[..., None]).to(q.dtype))
    return torch.cat(out)


def seq_kv_cache_bytes(cfg, B, S) -> int:
    """Stored bytes with logical (unpadded) kv heads: K and V, every layer,
    two bytes a value."""
    return 2 * cfg.num_layers * B * S * cfg.num_kv_heads * \
        cfg.resolved_head_dim * 2
