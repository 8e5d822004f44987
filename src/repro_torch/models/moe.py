"""Top-k mixture-of-experts FFN with capacity-bounded dispatch (the port of
``repro.models.moe``), and the hybrid_moe family's dropless layer over the
experts one device holds (``held_moe_prefill`` / ``held_moe_decode``,
below).

Routing runs in f32: softmax over the router logits, the top-k experts a
token (ties to the lower expert index, as ``jax.lax.top_k`` breaks them),
their gates renormalised to sum to one. Capacity is per batch row: each
row's (token, k) pairs take slots in token-major order, a running count
per expert, and a pair whose slot reaches the capacity C is dropped (it
reads back zeros, Switch/GShard semantics). The experts run densely over
an (E, B·C, d) buffer as batched products (``torch.bmm``), empty slots
included, as in the reference.

Nothing here synchronises with the host or has a data-dependent shape, so
a decode step with MoE layers can be captured in a CUDA graph: one-hots
are comparisons with an ``arange``, and the buffer has one extra column a
row per expert that takes the dropped pairs, so no index goes out of
bounds; that column is never run through an expert, and the gather reads
zeros there.
"""
from __future__ import annotations

import math

import torch

from repro_torch import telemetry
from repro_torch.models.layers import gelu, he_init, per_shard, silu


def init_moe(gen: torch.Generator, d_model: int, d_ff: int,
             num_experts: int, dtype, shared_expert: bool,
             activation: str) -> dict:
    """The reference's leaves: ``router`` f32 (d, E); ``w_gate`` / ``w_up``
    (E, d, ff) and ``w_down`` (E, ff, d), no ``w_up`` for gelu; and with
    ``shared_expert`` a dense SwiGLU-shaped FFN ``shared``."""
    E = num_experts
    p = {"router": he_init(gen, (d_model, E), torch.float32, d_model),
         "w_gate": he_init(gen, (E, d_model, d_ff), dtype, d_model)}
    if activation == "swiglu":
        p["w_up"] = he_init(gen, (E, d_model, d_ff), dtype, d_model)
    p["w_down"] = he_init(gen, (E, d_ff, d_model), dtype, d_ff)
    if shared_expert:
        p["shared"] = {
            "w_gate": he_init(gen, (d_model, d_ff), dtype, d_model),
            "w_up": he_init(gen, (d_model, d_ff), dtype, d_model),
            "w_down": he_init(gen, (d_ff, d_model), dtype, d_ff),
        }
    return p


def _expert_ffn(p, buf, activation):
    """buf: (E, N, d) -> (E, N, d), expert e's FFN on its N rows."""
    g = torch.bmm(buf, p["w_gate"])
    h = silu(g) * torch.bmm(buf, p["w_up"]) if activation == "swiglu" \
        else gelu(g)
    return torch.bmm(h, p["w_down"])


def _dense_ffn(p, x, activation):
    g = x @ p["w_gate"]
    h = silu(g) * (x @ p["w_up"]) if activation == "swiglu" else gelu(g)
    return h @ p["w_down"]


def ranked_top_k(probs: torch.Tensor, k: int) -> tuple:
    """The ``k`` largest of ``probs`` along the last axis, in descending
    order, ties to the lower index (``jax.lax.top_k``'s order; ``torch.
    topk`` promises none): ``k`` argmax passes, each masking the last
    pick. Returns (values, int64 indices)."""
    ids = torch.arange(probs.shape[-1], device=probs.device)
    vals, idx, p = [], [], probs
    for _ in range(k):
        i = torch.argmax(p, dim=-1, keepdim=True)    # first maximal index
        vals.append(torch.gather(probs, -1, i))
        idx.append(i)
        p = torch.where(ids == i, float("-inf"), p)
    return torch.cat(vals, -1), torch.cat(idx, -1)


def route(router: torch.Tensor, x: torch.Tensor, k: int) -> tuple:
    """f32 router: (probs (..., E), top-k gates renormalised with a 1e-9
    floor (..., k), their experts (..., k))."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    top_p, top_i = ranked_top_k(probs, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_i


def capacity(S: int, k: int, E: int, capacity_factor: float) -> int:
    """Slots an expert has in one batch row of S tokens."""
    return max(int(math.ceil(S * k / E * capacity_factor)), k)


def dispatch_slots(top_i: torch.Tensor, E: int, C: int) -> tuple:
    """top_i (B, S, k) -> (experts (B, S·k), slots (B, S·k)): pair j of a
    row (token j // k, choice j % k) takes the next free slot of its
    expert in that row; C marks a dropped pair."""
    B = top_i.shape[0]
    flat_e = top_i.reshape(B, -1)
    ids = torch.arange(E, device=top_i.device)
    onehot = (flat_e[..., None] == ids).to(torch.int32)     # (B, S·k, E)
    slot = (torch.cumsum(onehot, dim=1) * onehot).sum(-1) - 1
    return flat_e, torch.where(slot < C, slot, C)


def _route_rows(x, router, k):
    return route(router, x, k)


def _dispatch(x, top_i, E: int, C: int):
    """The (E, B, C, d) buffer of rows ``x`` (B, S, d) routed by ``top_i``
    (B, S, k), and each pair's (expert, slot) (B, S·k)."""
    B, S, d = x.shape
    K = top_i.shape[-1]
    flat_e, slot = dispatch_slots(top_i, E, C)
    rows = torch.arange(B, device=x.device)[:, None]
    tok = torch.arange(S * K, device=x.device) // K     # pair -> token
    buf = x.new_zeros((E, B, C + 1, d))     # column C takes the drops
    buf[flat_e, rows, slot] = x[:, tok]
    return buf[:, :, :C], flat_e, slot


def _combine(flat_e, slot, top_p, out, K: int):
    """Each token's k experts' outputs from ``out`` (E, B, C, d), weighted
    by ``top_p`` (B, S, k) and summed: (B, S, d)."""
    E, B, C, d = out.shape
    S = top_p.shape[1]
    out = torch.cat([out, out.new_zeros((E, B, 1, d))], dim=2)
    gathered = out[flat_e, torch.arange(B, device=out.device)[:, None],
                   slot]                                    # (B, S·k, d)
    weighted = gathered * top_p.reshape(B, S * K, 1).to(gathered.dtype)
    # the reference adds the k terms of a token into zeros one by one; for
    # k <= 2 one sum rounded once is the same value
    return weighted.reshape(B, S, K, d).sum(dim=2)


def moe_apply(params, x, *, num_experts: int, top_k: int,
              capacity_factor: float = 1.25, activation: str = "swiglu",
              shard_fn=None):
    """x: (B, S, d) -> (y (B, S, d), aux), the Switch load-balance loss
    on the top-1 assignment. Capacity and slot order are per batch row, so
    rows cannot displace each other's tokens (a fleet slab's empty rows
    leave its live rows' routing alone). ``shard_fn`` places the
    dispatch buffer and the experts' output ("moe_buf")."""
    B, S, d = x.shape
    E, K = num_experts, top_k
    # routing, dispatch and combine are per batch row: with DTensors each
    # rank does its rows' (the router whole), and only the buffer moves
    probs, top_p, top_i = per_shard(_route_rows, (x, params["router"]),
                                    [(0,), (None,)], K, out_axes=[(0,)] * 3)
    ids = torch.arange(E, device=x.device)
    assign = (top_i[..., :1] == ids).float()                # top-1 one-hot
    aux = E * torch.mean(assign.mean(dim=(0, 1)) * probs.mean(dim=(0, 1)))

    C = capacity(S, K, E, capacity_factor)
    buf, flat_e, slot = per_shard(_dispatch, (x, top_i), (0,), E, C,
                                  out_axes=[(1,), (0,), (0,)])
    if shard_fn is not None:
        buf = shard_fn(buf, "moe_buf")
    out = _expert_ffn(params, buf.reshape(E, B * C, d),
                      activation).reshape(E, B, C, d)
    if shard_fn is not None:
        out = shard_fn(out, "moe_buf")
    # the pairs first: the combine is split as the batch is (the experts'
    # output comes back from the expert axes by the batch's)
    y = per_shard(_combine, (flat_e, slot, top_p, out),
                  [(0,), (0,), (0,), (1,)], K)
    if "shared" in params:
        y = y + _dense_ffn(params["shared"], x.reshape(B * S, d),
                           activation).reshape(B, S, d)
    return y, aux


def moe_dense_oracle(params, x, *, num_experts: int, top_k: int,
                     activation: str = "swiglu"):
    """O(T·E) oracle: every expert on every token, combined with the top-k
    gates in f32. No capacity drops: the tests hold ``moe_apply`` to it at
    a high capacity factor."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    probs, top_p, top_i = route(params["router"], xt, top_k)
    gates = torch.zeros_like(probs).scatter(-1, top_i, top_p)
    outs = _expert_ffn(params, xt.expand(num_experts, -1, -1).contiguous(),
                       activation)                          # (E, T, d)
    y = torch.einsum("te,etd->td", gates, outs.float())
    if "shared" in params:
        y = y + _dense_ffn(params["shared"], xt, activation).float()
    return y.reshape(B, S, d).to(x.dtype)


# ------------------------------------------------- dropless, held experts
# tokens a grouped prefill routes at a time: bounds the (tokens x top-k)
# pair buffers (a block of 8,192 tokens at top-10 and d 4,096 is 0.67 GB
# of gathered bf16 rows and 1.3 GB of f32 outputs)
HELD_BLOCK = 8192


def init_held_moe(gen: torch.Generator, d_model: int, d_ff: int,
                  shared_ff: int, num_experts: int, held: int,
                  dtype) -> dict:
    """A dropless expert layer that holds experts [0, ``held``) of
    ``num_experts`` (expert parallelism's share of one device): ``router``
    f32 (d, E) over every expert; ``w_gate`` / ``w_up`` (held, d, ff) and
    ``w_down`` (held, ff, d), SwiGLU; and the always-on shared SwiGLU
    expert ``shared`` of width ``shared_ff``."""
    return {
        "router": he_init(gen, (d_model, num_experts), torch.float32,
                          d_model),
        "w_gate": he_init(gen, (held, d_model, d_ff), dtype, d_model),
        "w_up": he_init(gen, (held, d_model, d_ff), dtype, d_model),
        "w_down": he_init(gen, (held, d_ff, d_model), dtype, d_ff),
        "shared": {
            "w_gate": he_init(gen, (d_model, shared_ff), dtype, d_model),
            "w_up": he_init(gen, (d_model, shared_ff), dtype, d_model),
            "w_down": he_init(gen, (shared_ff, d_model), dtype, shared_ff),
        }}


def _held_block(params, xt, keep, top_k: int):
    """The held experts' part of the routed sum over tokens ``xt`` (T, d),
    f32 (T, d): pairs sorted by expert into grouped products, no pair
    dropped; tokens where ``keep`` is False and pairs whose expert is not
    held route nowhere. Counts the pairs routed (``moe.pairs``) and the
    rows the grouped products compute (``moe.slots``), on the device."""
    T, d = xt.shape
    held = params["w_gate"].shape[0]
    with telemetry.span("moe.dispatch"):
        _, top_p, top_i = route(params["router"], xt, top_k)
        key = torch.where(keep[:, None] & (top_i < held), top_i,
                          held).reshape(-1)                  # (T k,)
        order = torch.argsort(key, stable=True)
        ends = torch.searchsorted(
            key[order], torch.arange(held, dtype=key.dtype, device=xt.device),
            right=True).to(torch.int32)
        xs = xt[order // top_k]
    # one grouped product an expert matrix: group e the sorted rows
    # [ends[e-1], ends[e]); rows past ends[-1] come out undefined
    h = silu(torch._grouped_mm(xs, params["w_gate"], offs=ends)) \
        * torch._grouped_mm(xs, params["w_up"], offs=ends)
    o = torch._grouped_mm(h, params["w_down"], offs=ends)
    live = torch.arange(o.shape[0], device=xt.device) < ends[-1]
    out = torch.empty_like(o).index_copy_(
        0, order, torch.where(live[:, None], o, 0))
    kept = key < held
    gate = torch.where(kept, top_p.reshape(-1), 0.0).view(T, 1, top_k)
    telemetry.count_on_device("moe.pairs", kept.sum(), xt.device)
    telemetry.count_on_device("moe.slots", ends[-1], xt.device)
    return torch.bmm(gate, out.view(T, top_k, d).float()).view(T, d)


def held_moe_prefill(params, x, *, top_k: int, valid=None):
    """Dropless MoE FFN over a prompt batch x (B, S, d), positions where
    ``valid`` (B, S) is False (a bucket's pads) routed to no expert: the
    held experts' gated outputs plus the shared expert, in x's dtype.
    Tokens go ``HELD_BLOCK`` at a time."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    keep = torch.ones(B * S, dtype=torch.bool, device=x.device) \
        if valid is None else valid.reshape(-1)
    routed = torch.cat([
        _held_block(params, xt[i:i + HELD_BLOCK], keep[i:i + HELD_BLOCK],
                    top_k) for i in range(0, B * S, HELD_BLOCK)])
    y = routed + _dense_ffn(params["shared"], xt, "swiglu").float()
    return y.to(x.dtype).view(B, S, d)


def held_moe_decode(params, x, *, top_k: int):
    """Dropless MoE FFN over one token a row, x (B, 1, d): every held
    expert over every row, weighted by a gate that is zero where the row
    did not pick it (at decode batches each held expert is picked by some
    row, so its weights are read either way), plus the shared expert, in
    x's dtype. No host sync and static shapes: a CUDA graph captures it.
    Returns (y, top_i): the rows' picks (B, k), which the step counts once
    for all its layers (``count_held_decode``)."""
    B, _, d = x.shape
    xt = x.reshape(B, d)
    held, E = params["w_gate"].shape[0], params["router"].shape[1]
    _, top_p, top_i = route(params["router"], xt, top_k)
    gates = torch.zeros((B, E), dtype=torch.float32, device=x.device) \
        .scatter(1, top_i, top_p)[:, :held]
    h = silu(torch.matmul(xt, params["w_gate"])) \
        * torch.matmul(xt, params["w_up"])                   # (held, B, ff)
    o = torch.bmm(h, params["w_down"])                       # (held, B, d)
    y = torch.einsum("be,ebd->bd", gates, o.float())
    y = y + _dense_ffn(params["shared"], xt, "swiglu").float()
    return y.to(x.dtype).view(B, 1, d), top_i


def count_held_decode(picks, held: int, rows=None) -> None:
    """Count a decode step's expert work on the device, once for all its
    layers (``picks``: each layer's (B, k) expert ids): ``moe.pairs`` the
    picks of held experts by the rows the step writes (``rows``, an int
    index tensor, or every row), ``moe.slots`` every held expert over
    every row of every layer."""
    top = torch.stack(picks)                                 # (L, B, k)
    L, B, _ = top.shape
    hits = (top < held).sum((0, 2))                          # (B,)
    if rows is not None:
        hits = torch.zeros(B, dtype=torch.bool, device=top.device) \
            .index_fill(0, rows.long(), True) * hits
    telemetry.count_on_device("moe.pairs", hits.sum(), top.device)
    telemetry.count_on_device("moe.slots", L * held * B, top.device)
