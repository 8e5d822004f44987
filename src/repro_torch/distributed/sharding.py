"""Sharding rules of the port, the serving half (``repro.distributed.
sharding``'s twin): the per-dim axis entries of every serve-state leaf and
of a ``FleetGroup``'s slab over a mesh (``launch.mesh.Mesh``).

An entry is the reference's ``PartitionSpec`` entry: ``None`` (the dim is
whole on every device), an axis name, or a tuple of axis names (the dim is
split over their product). A dim whose size the entry's axes do not divide
falls back to ``None``, as in the reference. The rules return entries:
``serving.engine.FleetGroup`` lays its slab out as ``fleet_slab_shardings``
gives it for a pure ``('fleet',)`` mesh, its rows in one contiguous block a
shard.

Serve mode: weights whole on every device; KV caches split batch over the
data-like axes and kv heads over ``model``. The port's fleet slab is FLAT
(``(L, cap * max_batch, ...)``: member f's slot s is row f * max_batch +
s), so its rows dim carries the reference's leading fleet axis and the
per-replica batch axis together: entry ``("fleet",) + data axes``.

``ShardPlan``, the param and activation rules, ``serve_state_shardings``
(it takes a ``ShardPlan``) and ``collective_bytes`` belong to the
parameter half and are not here.
"""
from __future__ import annotations

import numpy as np

_DP_AXES = ("pod", "data", "expert")
_KV_LEAVES = ("k", "v", "attn_k", "attn_v", "self_k", "self_v", "cross_k",
              "cross_v")


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _fits(spec_entry, dim: int, mesh) -> bool:
    """Does ``dim`` divide over the mesh axes of ``spec_entry``?"""
    if spec_entry is None:
        return True
    size = int(np.prod([mesh.shape[a] for a in _axes(spec_entry)]))
    return dim % size == 0


def _serve_state_entries(name: str, ndim: int, dp, tp) -> tuple:
    """Per-dim axis entries for one serve-state leaf (batch over data,
    heads over model), the reference's rule. Leaf layouts (leading stack
    axis first):

      lm k/v            (L, B, S, G, hd)
      ssm 'ssm'         (L, B, H, P, N)
      ssm 'conv'        (L, B, W-1, C)
      hybrid attn_k/v   (n_inv, B, S, G, hd)
      encdec self/cross (L, B, S, G, hd)
    """
    if name in _KV_LEAVES:
        return (None, dp, None, tp, None)
    if name == "ssm":
        return (None, dp, tp, None, None)
    if name == "conv":
        return (None, dp, None, tp)
    return (None,) * ndim


def _serve_axes(mesh) -> tuple:
    dp = tuple(a for a in _DP_AXES if a in mesh.axis_names) or None
    tp = "model" if "model" in mesh.axis_names else None
    return dp, tp


def fleet_slab_shardings(mesh, slab) -> dict:
    """Per-leaf entries of a flat ``FleetGroup`` slab (name -> tensor or
    shape, each ``(L, cap * max_batch, ...)``): the rows dim over the
    ``fleet`` axis (and the data-like axes, the reference's per-replica
    batch), the other dims by the serve-mode rules on any ``model`` axis
    also present (a pure ``('fleet',)`` mesh keeps them whole). Weights
    are not placed this way: every shard holds them whole. A rows dim that
    the axes do not divide falls back to ``None``, so callers keep the
    slab's capacity a multiple of the shard count (``FleetGroup._cap_for``)."""
    if "fleet" not in mesh.axis_names:
        raise ValueError(
            f"serving mesh needs a 'fleet' axis, got {mesh.axis_names}")
    dp, tp = _serve_axes(mesh)
    out = {}
    for name, leaf in slab.items():
        shape = tuple(getattr(leaf, "shape", leaf))
        per = _serve_state_entries(name, len(shape), dp, tp)
        rows = ("fleet",) + _axes(per[1])
        entries = (per[0], rows if len(rows) > 1 else "fleet") + per[2:]
        out[name] = tuple(e if _fits(e, d, mesh) else None
                          for e, d in zip(entries, shape))
    return out
