"""Serving meshes of the port (``repro.launch.mesh``'s twin).

A ``Mesh`` is an ndarray of ``torch.device``s with named axes, driven by
ONE process: the host loop that runs a fleet group's tick issues each
shard's work on that shard's device, as the reference's single-controller
jax mesh does (one logical dispatch and one sync a tick, the same host
bookkeeping). No ``torch.distributed`` process group is involved.

On a card, ``make_fleet_mesh(n)`` takes ``cuda:0 .. cuda:n-1`` and raises
when fewer cards exist: n shards are never mapped onto fewer cards
silently. On the CPU, ``set_host_device_count(n)`` is the counterpart of
the reference's virtual host devices (``--xla_force_host_platform_
device_count``): it exposes n shards that all live on ``cpu``. A mesh
over a repeated device (two shards on one card) is built only from an
explicit device list passed to ``make_mesh``. ``Mesh.row_blocks`` gives a
fleet group its row blocks (``fleet`` x the data-like axes), each with
its devices along ``model``.

The parameter half runs SPMD instead: one process a device under a
``torch.distributed`` process group, the parameters ``DTensor``s over a
``DeviceMesh`` (``distributed.sharding``). ``make_device_mesh`` builds
one over the group's first ranks (NCCL on cards, gloo on the CPU, the
``fake`` backend in the dry-run), ``make_production_mesh`` the
256/512-device mesh of the dry-run, and ``parse_mesh_spec(...,
distributed=True)`` one from a spec. A mesh larger than the group raises.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

_host_devices = 1           # virtual CPU devices (set_host_device_count)


class Mesh:
    """``devices`` (an ndarray of ``torch.device``, one dim per axis) with
    ``axis_names``. ``shape`` maps each axis name to its size, in axis
    order (the reference's ``mesh.shape``); ``size`` is the device count."""

    def __init__(self, devices, axis_names):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of {devices.ndim} dims got axis names "
                             f"{axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis name in {axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def row_blocks(self, rows, along: str) -> list:
        """For each index over the axes ``rows`` that the mesh has
        (row-major, in the order given), the devices along ``along`` (one
        device when the mesh has no such axis); every other axis at index
        0. A fleet group's row blocks over ``("fleet", "pod", "data",
        "expert")``, each with its ``model`` devices."""
        names = self.axis_names
        order = [a for a in rows if a in names]
        n = int(np.prod([self.shape[a] for a in order]))
        if along in names:
            order.append(along)
        rest = [a for a in names if a not in order]
        arr = np.transpose(self.devices,
                           [names.index(a) for a in order + rest])
        arr = arr[(Ellipsis,) + (0,) * len(rest)]
        return [list(r) for r in np.asarray(arr, dtype=object).reshape(
            n, -1)]

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis``, at index 0 of every other axis."""
        i = self.axis_names.index(axis)
        return list(np.moveaxis(self.devices, i, 0).reshape(
            self.devices.shape[i], -1)[:, 0])


def set_host_device_count(n: int) -> None:
    """Expose ``n`` virtual CPU devices: meshes built for ``device="cpu"``
    may then hold up to ``n`` shards, every one on ``cpu``."""
    global _host_devices
    n = int(n)
    if n < 1:
        raise ValueError(f"need at least one device, got {n}")
    _host_devices = n


@contextlib.contextmanager
def host_device_count(n):
    """``set_host_device_count(n)`` inside the block, the count before it
    after; ``n=None`` leaves the count as it is."""
    global _host_devices
    before = _host_devices
    if n is not None:
        set_host_device_count(n)
    try:
        yield
    finally:
        _host_devices = before


def _visible(device: str) -> list:
    """The visible devices of kind ``device``: the virtual host devices
    for ``cpu``, every card for ``cuda`` (none is an error)."""
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")] * _host_devices
    if kind != "cuda":
        raise ValueError(f"unsupported device kind {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA mesh was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' for a mesh of virtual CPU devices")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape, axes, devices=None, device: str = "cuda") -> Mesh:
    """A mesh of ``shape`` with axis names ``axes``. ``devices``: an
    explicit list of ``prod(shape)`` devices, repeats allowed (two shards
    on one card); else the first ``prod(shape)`` visible devices of kind
    ``device``, and too few of them is an error."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n = int(np.prod(shape))
    if devices is None:
        have = _visible(device)
        if len(have) < n:
            kind = torch.device(device).type
            hint = ("call set_host_device_count (--devices) first"
                    if kind == "cpu" else "a mesh never maps its shards "
                    "onto fewer cards; pass an explicit device list to "
                    "repeat one")
            raise RuntimeError(f"mesh {dict(zip(axes, shape))} needs {n} "
                               f"{kind} device(s), {len(have)} visible: "
                               f"{hint}")
        devices = have[:n]
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {n} devices, "
                         f"got {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axes)


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """Small CPU mesh for tests (needs ``set_host_device_count``)."""
    return make_mesh((data, model), ("data", "model"), device="cpu")


def make_fleet_mesh(devices: int = 0, device: str = "cuda") -> Mesh:
    """1-D serving mesh: a ``FleetGroup``'s slab rows split over
    ``devices`` shards (every visible device of kind ``device`` when 0).
    On a card, shard d is ``cuda:d``; on the CPU, ``devices`` virtual
    shards (``set_host_device_count``)."""
    n = int(devices) or len(_visible(device))
    return make_mesh((n,), ("fleet",), device=device)


def make_device_mesh(shape, axes, device: str = "cuda"):
    """A ``torch.distributed`` ``DeviceMesh`` of ``shape`` with dim names
    ``axes`` over ranks 0 .. prod(shape) - 1 of the current process group
    (rank r at row-major position r), on devices of kind ``device``. Needs
    an initialised group at least that large: no silent fallback."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh of {len(shape)} dims got axis names {axes}")
    if not dist.is_initialized():
        raise RuntimeError("a DeviceMesh needs a torch.distributed process "
                           "group: call init_process_group first")
    n, world = int(np.prod(shape)), dist.get_world_size()
    if n > world:
        raise RuntimeError(f"mesh {dict(zip(axes, shape))} needs {n} ranks, "
                           f"the process group has {world}")
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA DeviceMesh was requested but "
                           "torch.cuda.is_available() is False")
    ranks = torch.arange(n, dtype=torch.int64).reshape(shape)
    return DeviceMesh(kind, ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """Single pod: (data=16, model=16) = 256 devices. Multi-pod:
    (pod=2, data=16, model=16) = 512 devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_device_mesh(shape, axes, device=device)


def parse_mesh_spec(spec: str, device: str = "cuda",
                    distributed: bool = False):
    """'2x8x16:data,expert,model' -> mesh over the visible devices of kind
    ``device`` (a ``Mesh``), or with ``distributed`` a ``DeviceMesh`` over
    the process group's first ranks (``make_device_mesh``)."""
    shape_s, axes_s = spec.split(":")
    shape = tuple(int(x) for x in shape_s.split("x"))
    axes = tuple(axes_s.split(","))
    if len(shape) != len(axes):
        raise ValueError(f"mesh spec {spec!r}: {len(shape)} sizes for "
                         f"{len(axes)} axes")
    if distributed:
        return make_device_mesh(shape, axes, device=device)
    return make_mesh(shape, axes, device=device)
