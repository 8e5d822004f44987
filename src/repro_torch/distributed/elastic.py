"""Elastic scaling of the port (``repro.distributed.elastic``'s twin):
rebuild the ``DeviceMesh`` and re-place the params when the data-parallel
width changes (a scale-up from the autoscaler, or a shrink after a
failure).

The TP ("model") axis is fixed by the checkpointed layout; elasticity
happens on the data axis, the knob the paper's GPSO autoscaler turns. A
mesh is built over ranks of the current process group; every rank of the
group takes part in building one (``DeviceMesh`` creates its sub-groups
collectively), also a rank the new mesh leaves out. Resharding gathers
each param whole on the old mesh and distributes it on the new one (the
reference's ``jax.device_put`` moves only the blocks that must move).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.sharding import (ShardPlan, _zip_map,
                                              param_shardings, placements)


def elastic_remesh(data: int, model: int, devices=None,
                   device: str = "cuda"):
    """A (data, model) ``DeviceMesh`` over the first data * model of
    ``devices`` (process-group ranks; every rank when None), on devices of
    kind ``device``. Fewer ranks than that raise."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(range(dist.get_world_size())) if devices is None \
        else [int(r) for r in devices]
    need = data * model
    if len(ranks) < need:
        raise ValueError(f"need {need} devices, have {len(ranks)}")
    sub = torch.tensor(ranks[:need], dtype=torch.int64).reshape(data, model)
    return DeviceMesh(torch.device(device).type, sub,
                      mesh_dim_names=("data", "model"))


def reshard_params(params, new_plan: ShardPlan):
    """Move live params (DTensors) onto a new mesh and plan: each leaf is
    gathered whole on its mesh (every rank of that mesh takes part), then
    distributed by ``param_shardings(new_plan, ...)``. A rank outside the
    new mesh keeps an empty block."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    mesh = new_plan.mesh

    def one(x, e):
        whole = x.full_tensor() if isinstance(x, DTensor) else x
        return distribute_tensor(whole, mesh, placements(mesh, e))
    return _zip_map(one, params, param_shardings(new_plan, params))


def survivors_mesh(mesh, failed_indices, model: int):
    """Shrink after failures: drop the data rows that hold a failed rank.
    ``failed_indices``: flat indices into the mesh's rank array. Returns a
    (data', model) ``DeviceMesh`` over the surviving rows (the restart path
    pairs this with a checkpoint restore)."""
    from torch.distributed.device_mesh import DeviceMesh

    devs = np.asarray(mesh.mesh.tolist()).reshape(-1, model)
    bad_rows = {int(fi) // model for fi in failed_indices}
    rows = [r for r in range(devs.shape[0]) if r not in bad_rows]
    if not rows:
        raise ValueError("no surviving data rows")
    return DeviceMesh(mesh.device_type, torch.tensor(devs[rows]),
                      mesh_dim_names=("data", "model"))
