"""The optimizer stack: AdamW with clipping and a cosine schedule, and SGD
(the port of ``repro.models.optim``).

Update steps are plain functions over the port's parameter trees (nested
dicts and lists of tensors, ``core.tree``): ``update(grads, state,
params)`` returns new trees and leaves its arguments as they were, as the
reference's do. The arithmetic and its order are the reference's: f32
upcast, clipping by ``min(1, clip_norm / max(gnorm, 1e-9))``, bias
correction at the new step, the weight decay inside the step before the
learning rate, the learning rate at the new step, moments stored in
``moment_dtype`` (bf16 for the largest models). ``torch.optim.AdamW``
rounds differently and applies its decay elsewhere. ``step`` is an int32
tensor on the params' device, so an update reads nothing back to the
host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.tree import leaves, tree_map, unflatten


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> Callable:
    """``lr(step)``: linear warmup to ``peak_lr`` over ``warmup`` steps,
    then a cosine down to ``floor_frac * peak_lr`` at ``total``; an f32
    tensor on ``step``'s device."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor_frac + (1 - floor_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr


def _local(x):
    """A DTensor scalar's value on this rank (it is whole on every rank);
    anything else as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def _on_blocks(fn, *xs):
    """``fn(*xs)``, elementwise over tensors of one shape. DTensors laid
    out alike (a param, its gradient and moments) go through it block by
    block on each rank, and the results take their layout: the blocks are
    the whole answer, and DTensor's own rule search over an elementwise
    op's placements cost ~0.1 s a new op on a 3-D mesh."""
    if not isinstance(xs[0], DTensor):
        return fn(*xs)
    mesh, lay = xs[0].device_mesh, tuple(xs[0].placements)
    if any(tuple(x.placements) != lay for x in xs):
        raise ValueError("elementwise blocks need one layout, got "
                         f"{[tuple(x.placements) for x in xs]}")
    return tuple(DTensor.from_local(o, mesh, lay, run_check=False)
                 for o in fn(*(x.to_local() for x in xs)))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: torch.dtype = torch.float32

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else torch.full(
            (), self.lr, dtype=torch.float32, device=step.device)

    def init(self, params):
        # zeros_like: a DTensor param's moments take its layout
        zeros = lambda p: torch.zeros_like(p, dtype=self.moment_dtype)
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=leaves(params)[0].device)}

    def update(self, grads, state, params):
        """(new params, new state, {"grad_norm", "lr"})."""
        step = state["step"] + 1
        stepf = step.float()
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0) if self.clip_norm else 1.0
        lr = self._lr(step)
        c1 = 1 - self.b1 ** stepf
        c2 = 1 - self.b2 ** stepf

        def upd(g, mu, nu, p, scale=_local(scale)):
            g = g.float() * scale
            mu1 = self.b1 * mu.float() + (1 - self.b1) * g
            nu1 = self.b2 * nu.float() + (1 - self.b2) * g * g
            delta = (mu1 / c1) / (torch.sqrt(nu1 / c2) + self.eps)
            delta = delta + self.weight_decay * p.float()
            new_p = p.float() - lr * delta
            return (new_p.to(p.dtype), mu1.to(self.moment_dtype),
                    nu1.to(self.moment_dtype))

        out = [_on_blocks(upd, *a) for a in zip(
            leaves(grads), leaves(state["mu"]), leaves(state["nu"]),
            leaves(params))]
        new_state = {"mu": unflatten(params, [o[1] for o in out]),
                     "nu": unflatten(params, [o[2] for o in out]),
                     "step": step}
        return (unflatten(params, [o[0] for o in out]), new_state,
                {"grad_norm": gnorm, "lr": lr})


@dataclasses.dataclass(frozen=True)
class SGD:
    """Plain or momentum SGD (the reference keeps it for the RL inner
    loops)."""
    lr: float = 1e-3
    momentum: float = 0.0

    def init(self, params):
        if not self.momentum:
            return {}
        return {"vel": tree_map(torch.zeros_like, params)}

    def update(self, grads, state, params):
        if not self.momentum:
            return tree_map(lambda p, g: p - self.lr * g, params,
                            grads), state, {}
        vel = tree_map(lambda v, g: self.momentum * v + g, state["vel"],
                       grads)
        return (tree_map(lambda p, v: p - self.lr * v, params, vel),
                {"vel": vel}, {})
