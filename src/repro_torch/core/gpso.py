"""Hybrid Genetic-Particle-Swarm Optimization (paper §3.2, Eq. 9-11); the
port of ``repro.core.gpso``.

GA phase (roulette selection, single-point crossover, random mutation)
explores; its elite seeds the PSO phase (velocity/position updates, Eq.10-11)
which refines toward the global optimum. Vectorized over the population in
torch on the key's device; the generations are a Python loop (the reference
unrolls them with ``lax.scan`` under ``jit``).

``fitness_fn`` maps (population (P, D), ctx tuple of tensors) -> costs (P,);
lower is better.

**Random draws.** The reference draws from ``jax.random``, whose streams
torch cannot reproduce. So every draw here comes from a *key*: an object
with the reference's key-tree shape, split at the same places
(``split(n)``) and drawn from once per leaf:

    key.split(n)                 -> n child keys
    key.uniform(shape, lo, hi)   -> f32 tensor in [lo, hi)
    key.randint(shape, lo, hi)   -> int tensor in [lo, hi)
    key.categorical(logits, n)   -> n indices drawn from softmax(logits)

``TorchKey`` is the port's: ``torch.Generator`` draws seeded from
``numpy.random.SeedSequence`` children. A key that wraps ``jax.random``
keys (the tests have one) makes the port's plans equal the reference's.
Ties between members (many round to the same integer allocation) are
broken as the reference does: stable ``argsort``, first-index ``argmin``.
Nothing here syncs with the host: the best member is picked with a
one-element index tensor (indexing with a 0-d tensor would read it back to
the host), so a whole plan queues on the device behind one fetch.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


class TorchKey:
    """A ``jax.random``-style key over ``torch.Generator``s: a pure value
    (splitting or drawing never changes it), so one key drawn twice gives
    the same numbers, and deep copies (``ControlPlane.state_dict``) carry
    the stream."""

    def __init__(self, seq: np.random.SeedSequence, device: torch.device):
        self.seq = seq
        self.device = torch.device(device)

    @classmethod
    def from_seed(cls, seed: int, device="cuda") -> "TorchKey":
        return cls(np.random.SeedSequence(seed), resolve_device(device))

    def split(self, n: int = 2) -> list:
        # children named by (n, i) under this key, never by a spawn counter
        # (SeedSequence.spawn would make a second split differ)
        return [TorchKey(np.random.SeedSequence(
            self.seq.entropy, spawn_key=self.seq.spawn_key + (n, i)),
            self.device) for i in range(n)]

    def generator(self) -> torch.Generator:
        """A ``torch.Generator`` on the key's device seeded from the key
        (the same one each time: the key is a value)."""
        seed = int(self.seq.generate_state(1, np.uint64)[0])
        return torch.Generator(device=self.device).manual_seed(seed)

    def uniform(self, shape, lo=0.0, hi=1.0) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self.generator(),
                       device=self.device)
        return torch.clamp(u * (hi - lo) + lo, min=lo)

    def randint(self, shape, lo: int, hi: int) -> torch.Tensor:
        return torch.randint(lo, hi, tuple(shape),
                             generator=self.generator(), device=self.device)

    def categorical(self, logits: torch.Tensor, n: int) -> torch.Tensor:
        """n draws from softmax(logits) (1-D) by the Gumbel-max trick: on
        the device, with no host sync."""
        u = torch.rand((n,) + tuple(logits.shape),
                       generator=self.generator(), device=self.device)
        tiny = torch.finfo(u.dtype).tiny
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
        return torch.argmax(logits + gumbel, dim=-1)


def slo_violation_cost(load, pressure, target):
    """Tier-weighted SLO-violation cost term for Eq.9 objectives.

    load: (P, N) per-node load under each candidate allocation; pressure:
    (N,) tier-weighted backlog share per node; target: scalar provisioning
    headroom. Returns (P,): the pressure-weighted mass of load above
    target. Zero pressure makes the term vanish."""
    return torch.sum(pressure[None, :] * torch.clamp(load - target, min=0.0),
                     dim=-1)


def preemption_risk_cost(alloc, risk):
    """Spot-churn cost term for Eq.9 objectives: alloc (P, N) candidate
    replica share per node; risk (N,) per-node 0/1 preemption signal.
    Returns (P,): the allocation mass placed on at-risk nodes."""
    return torch.sum(risk[None, :] * alloc, dim=-1)


def _roulette(key, costs, n: int):
    """Sample n indices with probability ∝ softmax(-normalized cost)."""
    z = (costs - costs.mean()) / (costs.std(correction=0) + 1e-9)
    return key.categorical(-z, n)


def ga_generation(key, pop, costs, ctx, *, crossover_p, mutation_p, elite,
                  lo, hi, fitness_fn):
    """One GA generation. pop: (P, D)."""
    P, D = pop.shape
    k1, k2, k3, k4, k5 = key.split(5)
    order = torch.argsort(costs, stable=True)
    elites = pop[order[:elite]]

    n_child = P - elite
    pa = pop[_roulette(k1, costs, n_child)]
    pb = pop[_roulette(k2, costs, n_child)]
    # single-point crossover
    cut = k3.randint((n_child, 1), 1, D)
    cols = torch.arange(D, device=pop.device)[None, :]
    do_cross = k4.uniform((n_child, 1), 0.0, 1.0) < crossover_p
    child = torch.where((cols < cut) | ~do_cross, pa, pb)
    # random-reset mutation
    k5a, k5b = k5.split(2)
    mut_mask = k5a.uniform(child.shape, 0.0, 1.0) < mutation_p
    rand_vals = k5b.uniform(child.shape, lo, hi)
    child = torch.where(mut_mask, rand_vals, child)

    new_pop = torch.cat([elites, child], dim=0)
    return new_pop, fitness_fn(new_pop, ctx)


def pso_iteration(key, pos, vel, pbest, pbest_cost, gbest, gbest_cost, ctx, *,
                  w, c1, c2, lo, hi, fitness_fn):
    """Eq. 10-11."""
    k1, k2 = key.split(2)
    r1 = k1.uniform(pos.shape, 0.0, 1.0)
    r2 = k2.uniform(pos.shape, 0.0, 1.0)
    vel = w * vel + c1 * r1 * (pbest - pos) + c2 * r2 * (gbest[None] - pos)
    pos = torch.clamp(pos + vel, lo, hi)
    costs = fitness_fn(pos, ctx)
    better = costs < pbest_cost
    pbest = torch.where(better[:, None], pos, pbest)
    pbest_cost = torch.where(better, costs, pbest_cost)
    i = torch.argmin(pbest_cost, dim=0, keepdim=True)
    gb_cost, gb = pbest_cost[i][0], pbest[i][0]
    upd = gb_cost < gbest_cost
    return pos, vel, pbest, pbest_cost, \
        torch.where(upd, gb, gbest), torch.where(upd, gb_cost, gbest_cost)


def _ga(key, fitness_fn, n_dims, cfg, lo, hi, ctx, generations):
    kinit, kga = key
    pop = kinit.uniform((cfg.ga_pop, n_dims), lo, hi)
    costs = fitness_fn(pop, ctx)
    hist = []
    for k in kga.split(generations):
        pop, costs = ga_generation(k, pop, costs, ctx,
                                   crossover_p=cfg.ga_crossover,
                                   mutation_p=cfg.ga_mutation,
                                   elite=cfg.ga_elite, lo=lo, hi=hi,
                                   fitness_fn=fitness_fn)
        hist.append(torch.min(costs))
    return pop, costs, hist


def gpso_minimize(key, fitness_fn, n_dims: int, cfg, lo=0.0, hi=1.0,
                  ctx=None):
    """Hybrid GA->PSO. Returns (best_x (D,), best_cost, history (G+I,)),
    tensors on the key's device; nothing syncs with the host.

    cfg needs: ga_pop, ga_generations, ga_elite, ga_crossover, ga_mutation,
    pso_iters, pso_inertia, pso_c1, pso_c2.
    """
    kinit, kga, kpso = key.split(3)
    pop, costs, hist = _ga((kinit, kga), fitness_fn, n_dims, cfg, lo, hi,
                           ctx, cfg.ga_generations)
    # GA elite seeds the swarm (the paper's "high quality chromosomes ...
    # establish the initial position of the particle swarm")
    order = torch.argsort(costs, stable=True)
    pos = pop[order]
    costs = costs[order]
    vel = torch.zeros_like(pos)
    pbest, pbest_cost = pos, costs
    g_i = torch.argmin(costs, dim=0, keepdim=True)
    gbest, gbest_cost = pos[g_i][0], costs[g_i][0]
    for k in kpso.split(cfg.pso_iters):
        pos, vel, pbest, pbest_cost, gbest, gbest_cost = pso_iteration(
            k, pos, vel, pbest, pbest_cost, gbest, gbest_cost, ctx,
            w=cfg.pso_inertia, c1=cfg.pso_c1, c2=cfg.pso_c2, lo=lo, hi=hi,
            fitness_fn=fitness_fn)
        hist.append(gbest_cost)
    return gbest, gbest_cost, torch.stack(hist)


def ga_only_minimize(key, fitness_fn, n_dims: int, cfg, lo=0.0, hi=1.0,
                     ctx=None):
    """Ablation: GA without the PSO refinement."""
    kinit, kga = key.split(2)
    pop, costs, hist = _ga((kinit, kga), fitness_fn, n_dims, cfg, lo, hi,
                           ctx, cfg.ga_generations + cfg.pso_iters)
    i = torch.argmin(costs, dim=0, keepdim=True)
    return pop[i][0], costs[i][0], torch.stack(hist)
