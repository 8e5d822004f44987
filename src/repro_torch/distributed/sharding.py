"""Sharding rules of the port (``repro.distributed.sharding``'s twin): the
parameter, activation, batch and serve-state rules of a ``ShardPlan``, the
placement of a tree as ``DTensor``s over a ``torch.distributed``
``DeviceMesh``, the fleet slab's rules, and the collective accounting.

An entry is the reference's ``PartitionSpec`` entry: ``None`` (the dim is
whole on every device), an axis name, or a tuple of axis names (the dim is
split over their product). A rule gives one entry a dim, as a tuple; ``()``
is the reference's ``P()`` (every dim whole). A dim whose size the entry's
axes do not divide falls back to ``None``, as in the reference.

Two regimes, as the reference's:
  train -- FSDP over the data-like axes ("pod", "data", "expert") on each
           weight's non-TP dim, TP over "model" (heads, d_ff, vocab); the
           optimizer moments follow the weights.
  serve -- weights whole over the data axes, TP over "model"; KV caches
           split batch over data and kv heads over "model".
Rules are written against a weight's *trailing* dims: the reference stacks
layers along leading axes, which stay whole; the port keeps one dict a
layer, so its leaves have no leading axes and take the same trailing
entries.

The rules read only the mesh's axis names and sizes (``_mesh_shape``), so
they take a ``DeviceMesh`` (names in ``mesh_dim_names``), the port's
single-process ``launch.mesh.Mesh`` or any object with the reference's
``shape`` / ``axis_names``. ``placements`` turns entries into DTensor
placements: a dim whose entry names axes (a, b, ...) is ``Shard(dim)`` on
each of those mesh dims, the first axis major, so rank r holds the block
that the reference's GSPMD gives device r. ``place`` / ``place_params``
distribute a tree by its entries (the counterpart of ``jax.device_put``
with ``param_shardings``); ``make_shard_fn`` redistributes a DTensor
activation to a tag's entries (``with_sharding_constraint``'s).

``collective_bytes`` parses an HLO dump as the reference does (kept for
its callers' text); ``comm_bytes`` counts the same quantity, by the same
kinds and ring factors, over the ``torch.ops._c10d_functional``
collectives a block of DTensor code issues.

The serving half: ``serve_state_shardings`` and ``fleet_slab_shardings``
(``serving.engine.FleetGroup`` lays its slab out by the latter: its rows
in contiguous blocks over ``fleet`` x the data-like axes, and over
``model`` each leaf's heads by ``HeadLayout``, the reference's head
ranges). The port's
fleet slab is FLAT (``(L, cap * max_batch, ...)``: member f's slot s is
row f * max_batch + s), so its rows dim carries the reference's leading
fleet axis and the per-replica batch axis together: entry ``("fleet",) +
data axes``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

_DP_AXES = ("pod", "data", "expert")
_KV_LEAVES = ("k", "v", "attn_k", "attn_v", "self_k", "self_v", "cross_k",
              "cross_v")


def _mesh_shape(mesh) -> dict:
    """Axis name -> size, in the mesh's axis order, for a ``DeviceMesh``
    (names in ``mesh_dim_names``) or a mesh with the reference's
    ``shape`` dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _fits(spec_entry, dim: int, mesh) -> bool:
    """Does ``dim`` divide over the mesh axes of ``spec_entry``?"""
    if spec_entry is None:
        return True
    shape = _mesh_shape(mesh)
    size = int(np.prod([shape[a] for a in _axes(spec_entry)]))
    return dim % size == 0


def _fitted(entries, shape, mesh) -> tuple:
    """``entries`` with every one that does not divide its dim dropped to
    None, and a one-axis tuple written as the axis (as ``PartitionSpec``
    writes it)."""
    return tuple((e[0] if isinstance(e, tuple) and len(e) == 1 else e)
                 if _fits(e, d, mesh) else None
                 for e, d in zip(entries, shape))


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    mesh: object
    mode: str                      # "train" | "serve"
    expert_sharding: str = "none"  # "none" | "data" (EP)

    @property
    def axis_names(self) -> tuple:
        return tuple(_mesh_shape(self.mesh))

    @property
    def dp_axes(self):
        """Data-like axes (batch + FSDP). A dedicated 'expert' axis (e.g.
        (data=2, expert=8, model=16)) still carries batch/FSDP for the
        non-MoE tensors."""
        return tuple(a for a in _DP_AXES if a in self.axis_names)

    @property
    def ep_axis(self):
        """Axes holding the expert dim: an explicit 'expert' mesh axis, or
        the data axes when expert_sharding='data'."""
        if "expert" in self.axis_names:
            return ("expert",)
        if self.expert_sharding == "data":
            return self.dp_axes
        return None

    @property
    def expert_inner_axes(self):
        """Data axes usable for the within-expert dims (not ep_axis)."""
        ep = self.ep_axis or ()
        return tuple(a for a in self.dp_axes if a not in ep) or None

    @property
    def tp_axis(self):
        return "model" if "model" in self.axis_names else None

    @property
    def fsdp(self):
        """Weight-sharding data axes (None in serve mode: whole)."""
        return self.dp_axes if self.mode == "train" else None

    @property
    def tp_size(self) -> int:
        return _mesh_shape(self.mesh).get("model", 1)


# --------------------------------------------------------------- param rules
def _trailing_rules(plan: ShardPlan, path_names: tuple) -> Optional[tuple]:
    """Entries of a param's trailing dims, by leaf name (and context)."""
    name = path_names[-1]
    in_moe = "moe" in path_names or "moe_layers" in path_names
    fsdp, tp = plan.fsdp, plan.tp_axis
    ep = plan.ep_axis if in_moe else None
    # MoE expert weights stay data-sharded in serve mode too; under EP the
    # expert dim takes its own axes and the within-expert dims the rest
    moe_fsdp = plan.expert_inner_axes if ep else \
        (plan.dp_axes if in_moe else fsdp)
    table = {
        "embed": (tp, fsdp),            # (V, d)
        "lm_head": (fsdp, tp),          # (d, V)
        "patch_proj": (fsdp, tp),       # (d, d)
        "dec_pos": (None, fsdp),        # (S, d)
        "wq": (fsdp, tp, None),         # (d, nq, hd)
        "wk": (fsdp, tp, None),
        "wv": (fsdp, tp, None),
        "wo": (tp, None, fsdp),         # (nq, hd, d)
        "bq": (tp, None),
        "bk": (tp, None),
        "bv": (tp, None),
        "router": (fsdp, None),         # (d, E)
        "in_proj": (fsdp, None),        # (d, d_in_proj)
        "out_proj": (tp, fsdp),         # (d_inner, d)
        "conv_w": (None, tp),           # (W, C)
        "conv_b": (tp,),
        "norm_scale": (tp,),            # (d_inner,)
        "head": (fsdp, None),
    }
    if name in ("w_gate", "w_up"):
        if in_moe and len(path_names) >= 2 and path_names[-2] != "shared":
            return (ep[0] if ep else None, moe_fsdp, tp)   # (E, d, ff)
        return (fsdp, tp)                                  # (d, ff)
    if name == "w_down":
        if in_moe and len(path_names) >= 2 and path_names[-2] != "shared":
            return (ep[0] if ep else None, tp, moe_fsdp)   # (E, ff, d)
        return (tp, fsdp)
    return table.get(name)


def _path_names(path) -> tuple:
    """Names of a tree path: dict keys (or jax ``DictKey``s) and list
    indices, as the reference names them."""
    return tuple(p.key if hasattr(p, "key") else str(p) for p in path)


def param_pspec(plan: ShardPlan, path, leaf) -> tuple:
    """Entries of one param (``leaf``: a tensor, or anything with a
    ``shape``) at ``path``: the trailing rule, leading dims whole; ``()``
    for a leaf without a rule."""
    right = _trailing_rules(plan, _path_names(path))
    shape = tuple(leaf.shape)
    if right is None or len(shape) < len(right):
        return ()
    lead = (None,) * (len(shape) - len(right))
    return _fitted(lead + tuple(right), shape, plan.mesh)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def param_shardings(plan: ShardPlan, params):
    """The entries of every param: a tree of ``params``' structure."""
    return _map_with_path(lambda path, leaf: param_pspec(plan, path, leaf),
                          params)


# ------------------------------------------------------------ placements
def _device_mesh(mesh):
    if getattr(mesh, "mesh_dim_names", None) is None:
        raise TypeError("placing tensors needs a torch DeviceMesh with "
                        f"named dims, got {type(mesh).__name__}")
    return mesh


def placements(mesh, entries) -> tuple:
    """DTensor placements (one a mesh dim) for ``entries`` (one a tensor
    dim, missing trailing entries whole): a dim whose entry names axes
    (a, b, ...) is ``Shard(dim)`` on each of those mesh dims. The axes of
    one entry must come in mesh order, so that the first is the major one,
    as in the reference."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(_mesh_shape(mesh))
    out = [Replicate()] * len(names)
    for dim, e in enumerate(entries):
        idx = [names.index(a) for a in _axes(e)]
        if idx != sorted(idx):
            raise ValueError(f"entry {e!r} names mesh axes out of the "
                             f"mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"in {entries!r}")
            out[i] = Shard(dim)
    return tuple(out)


def place(mesh, tree, entries_tree):
    """``tree``'s tensors as DTensors on ``mesh`` (a ``DeviceMesh``) by
    ``entries_tree`` (a tree of entries of the same structure). Every rank
    passes the whole tensor; rank r keeps its block."""
    from torch.distributed.tensor import distribute_tensor

    mesh = _device_mesh(mesh)

    def one(x, entries):
        return distribute_tensor(x, mesh, placements(mesh, entries))
    return _zip_map(one, tree, entries_tree)


def _zip_map(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_map(fn, v, o) for v, o in zip(tree, other)]
    return fn(tree, other)


def place_params(plan: ShardPlan, params):
    """``params`` as DTensors on the plan's ``DeviceMesh`` by
    ``param_shardings`` (``jax.device_put(params, param_shardings(...))``'s
    counterpart)."""
    return place(plan.mesh, params, param_shardings(plan, params))


def place_batch(plan: ShardPlan, batch: dict) -> dict:
    """A train or prefill batch as DTensors by ``batch_shardings``."""
    return place(plan.mesh, batch, batch_shardings(plan, batch))


def local_block(mesh, entries, shape, coords) -> tuple:
    """(offset, size) a dim of the block that the mesh coordinates
    ``coords`` (one index a mesh dim) hold of a tensor of ``shape``
    placed by ``entries``: the reference's ``devices_indices_map`` slice
    of that device."""
    names = _mesh_shape(mesh)
    axis_index = dict(zip(names, coords))
    out = []
    for dim, size in enumerate(shape):
        e = entries[dim] if dim < len(entries) else None
        off, n = 0, size
        for a in _axes(e):
            n //= names[a]
            off += axis_index[a] * n
        out.append((off, n))
    return tuple(out)


# ----------------------------------------------------------- activation tags
def _tag_specs(plan: ShardPlan) -> dict:
    dp, tp = plan.dp_axes, plan.tp_axis
    # the (E, B, C, d) dispatch buffer follows the expert weights' layout
    # (EP: E over the expert axes, batch over the rest), or the experts'
    # weights would be gathered to match it
    if plan.ep_axis:
        moe_buf = (plan.ep_axis, plan.expert_inner_axes, None, None)
    else:
        moe_buf = (None, dp, None, None)
    return {
        "act_btd": (dp, None, None),
        "logits": (dp, None, tp),
        "qkv": (dp, None, tp, None, None),
        "kv": (dp, None, tp, None),
        "moe_buf": moe_buf,
    }


def activation_entries(plan: ShardPlan, tag: str, shape) -> Optional[tuple]:
    """The entries ``make_shard_fn`` gives an activation of ``shape``
    under ``tag``; None for an unknown tag or another rank."""
    spec = _tag_specs(plan).get(tag)
    if spec is None or len(shape) != len(spec):
        return None
    return _fitted(spec, tuple(shape), plan.mesh)


def make_shard_fn(plan: ShardPlan):
    """``shard_fn(x, tag)`` for the model code: a DTensor ``x`` is
    redistributed to the tag's entries (``with_sharding_constraint``'s
    counterpart); a plain tensor, an unknown tag or a rank that does not
    match returns ``x`` unchanged. The port's one tag more,
    ``"serve_state"``, takes a sharded prefill's fresh state as ``meta``
    leaves and gives ``fresh_serve_state`` (GSPMD lays that state out by
    propagation in the reference)."""
    from torch.distributed.tensor import DTensor

    def shard_fn(x, tag):
        if tag == "serve_state":
            return fresh_serve_state(plan, x)
        if not isinstance(x, DTensor):
            return x
        entries = activation_entries(plan, tag, x.shape)
        if entries is None:
            return x
        want = placements(x.device_mesh, entries)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(x.device_mesh, want)

    return shard_fn


# --------------------------------------------------------------- input specs
def batch_shardings(plan: ShardPlan, batch_specs):
    """Entries of train/prefill inputs: the batch dim over the data axes
    (when they divide it), the rest whole. ``batch_specs`` is a tree of
    tensors or of anything with a ``shape``."""
    dp = plan.dp_axes

    def one(_, spec):
        shape = tuple(spec.shape)
        return _fitted((dp,) + (None,) * (len(shape) - 1), shape, plan.mesh)

    return _map_with_path(one, batch_specs)


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


def serve_state_shardings(plan: ShardPlan, state_specs, cfg) -> dict:
    """Entries of every decode-state leaf (name -> tensor or anything with
    a ``shape``): batch over the data axes, heads over model."""
    dp, tp = plan.dp_axes, plan.tp_axis

    def one(path, spec):
        shape = tuple(spec.shape)
        return _fitted(_serve_state_entries(str(path[-1]), len(shape), dp,
                                            tp), shape, plan.mesh)

    return _map_with_path(one, state_specs)


def fresh_serve_state(plan: ShardPlan, specs) -> dict:
    """Zeros for every leaf of a serve state (name -> tensor or anything
    with a ``shape`` and ``dtype``, ``meta`` tensors from the state's
    init), as DTensors on the plan's ``DeviceMesh`` laid out by
    ``serve_state_shardings``; each rank makes only its blocks."""
    from torch.distributed.tensor import DTensor

    mesh = _device_mesh(plan.mesh)
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    coords = mesh.get_coordinate()
    out = {}
    for name, e in serve_state_shardings(plan, specs, None).items():
        x = specs[name]
        shape = [n for _, n in local_block(mesh, e, x.shape, coords)]
        out[name] = DTensor.from_local(
            torch.zeros(shape, dtype=x.dtype, device=dev), mesh,
            placements(mesh, e), run_check=False)
    return out


def _serve_axes(mesh) -> tuple:
    names = tuple(_mesh_shape(mesh))
    dp = tuple(a for a in _DP_AXES if a in names) or None
    tp = "model" if "model" in names else None
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
    if "fleet" not in _mesh_shape(mesh):
        raise ValueError(
            f"serving mesh needs a 'fleet' axis, got "
            f"{tuple(_mesh_shape(mesh))}")
    dp, tp = _serve_axes(mesh)
    out = {}
    for name, leaf in slab.items():
        shape = tuple(getattr(leaf, "shape", leaf))
        per = _serve_state_entries(name, len(shape), dp, tp)
        rows = ("fleet",) + _axes(per[1])
        entries = (per[0], rows if len(rows) > 1 else "fleet") + per[2:]
        out[name] = _fitted(entries, shape, mesh)
    return out


def _head_dim(name: str, ndim: int) -> int:
    """The dim a ``model`` axis splits in leaf ``name`` by the rule; for
    the int8 cache's leaves, which no rule names, their kv-head dim."""
    per = _serve_state_entries(name, ndim, None, "model")
    return next((i for i, e in enumerate(per) if e == "model"),
                min(3, ndim - 1))


class HeadLayout:
    """The ``model`` half of a fleet slab's layout, for one row block of a
    ``FleetGroup`` (one index of the ``fleet`` and data-like axes):
    ``devices`` are that block's devices along ``model``, index 0 (the
    lead, which runs the work the split leaves whole) first. A leaf whose
    ``fleet_slab_shardings`` entry puts ``model`` on a dim -- the kv
    heads of an attention cache, the heads of the SSM state, the conv
    window's channels -- splits there, device m holding the block the
    reference's ``devices_indices_map`` gives model index m
    (``local_block``); a leaf that the axis does not divide, and the int8
    cache's four leaves, which no rule names, are whole on every device,
    as the reference replicates them. Leaves are ``layers.HeadBlocks``.

    As a ``shard_fn`` it lays out a prefill's fresh state (the
    "serve_state" tag) and leaves every other tag's value as it is."""

    lays_out_blocks = True

    def __init__(self, mesh, devices):
        self.mesh = mesh
        self.devices = [torch.device(d) for d in devices]

    def split(self, name: str, shape) -> tuple:
        """(dim, [(lo, hi)] a device along ``model``) of leaf ``name`` of
        ``shape``."""
        shape = tuple(shape)
        dim = _head_dim(name, len(shape))
        entries = fleet_slab_shardings(self.mesh, {name: shape})[name]
        if "model" not in _axes(entries[dim]):
            return dim, [(0, shape[dim])] * len(self.devices)
        model_only = [e if d == dim else None for d, e in enumerate(entries)]
        names = list(_mesh_shape(self.mesh))
        bounds = []
        for m in range(len(self.devices)):
            coords = [m if a == "model" else 0 for a in names]
            off, n = local_block(self.mesh, model_only, shape, coords)[dim]
            bounds.append((off, off + n))
        return dim, bounds

    def zeros(self, name: str, shape, dtype):
        """Zeros of leaf ``name`` of ``shape``, laid out."""
        from repro_torch.models.layers import HeadBlocks

        shape = tuple(shape)
        dim, bounds = self.split(name, shape)
        parts = [torch.zeros(shape[:dim] + (hi - lo,) + shape[dim + 1:],
                             dtype=dtype, device=d)
                 for d, (lo, hi) in zip(self.devices, bounds)]
        return HeadBlocks(parts, dim, bounds)

    def __call__(self, x, tag: str):
        if tag != "serve_state":
            return x
        return {n: self.zeros(n, t.shape, t.dtype) for n, t in x.items()}


# -------------------------------------------------- collective accounting
_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

# per-device traffic multiplier per collective kind (ring algorithms)
_TRAFFIC_FACTOR = {
    "all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
    "all-to-all": 1.0, "collective-permute": 1.0,
}


def _shape_bytes(type_str: str) -> int:
    total = 0
    for m in re.finditer(r"(\w+)\[([\d,]*)\]", type_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> dict:
    """Per-device collective traffic bytes by op kind of an HLO dump:
    result shapes x ring-traffic factors (all-reduce counts 2x). Returns
    {kind: bytes, ..., "total": bytes}."""
    pat = re.compile(
        r"=\s*((?:\([^)]*\))|(?:\w+\[[^\]]*\][^\s]*))\s+"
        r"(all-reduce|all-gather|reduce-scatter|all-to-all|"
        r"collective-permute)(?:-start)?\(")
    out = {k: 0.0 for k in _TRAFFIC_FACTOR}
    for line in hlo_text.splitlines():
        m = pat.search(line)
        if not m:
            continue
        kind = m.group(2)
        out[kind] += _shape_bytes(m.group(1)) * _TRAFFIC_FACTOR[kind]
    out["total"] = sum(out.values())
    return out


def _c10d_kinds() -> dict:
    ops = torch.ops._c10d_functional
    return {ops.all_reduce.default: "all-reduce",
            ops.all_reduce_.default: "all-reduce",
            ops.all_gather_into_tensor.default: "all-gather",
            ops.reduce_scatter_tensor.default: "reduce-scatter",
            ops.all_to_all_single.default: "all-to-all"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class _CommCounter(TorchDispatchMode):
    """Counts the result bytes x ring factor of each functional collective
    below DTensor: a DTensor op is handed back (``NotImplemented``) so that
    it runs and issues its collectives through this mode."""

    def __init__(self, out: dict):
        super().__init__()
        self.out = out
        self.kinds = _c10d_kinds()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        res = func(*args, **(kwargs or {}))
        kind = self.kinds.get(func)
        if kind is not None:
            self.out[kind] += _nbytes(res) * _TRAFFIC_FACTOR[kind]
        return res


@contextlib.contextmanager
def comm_bytes():
    """Count the collectives issued inside the block: yields a dict with
    ``collective_bytes``'s keys (per-device bytes by kind, ``total``
    filled in at exit), from each ``_c10d_functional`` collective's result
    bytes x the same ring factor (all-reduce 2x)."""
    out = {k: 0.0 for k in _TRAFFIC_FACTOR}
    with _CommCounter(out):
        yield out
    out["total"] = sum(v for k, v in out.items() if k != "total")
