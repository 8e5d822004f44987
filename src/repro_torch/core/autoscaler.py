"""Auto-scaling module (paper §3.2): forecast + GPSO resource planning,
plus the HPA and RBAS baselines from §4.2 (the port of
``repro.core.autoscaler``).

The optimization objective is Eq.9:
    min  Σ_i C_i·R_i + λ·max_i L_i(R)
where R_i is the replica count on node i and L_i(R) the node's load (demand /
provisioned capacity) under allocation R, with an unserved-demand penalty so
the optimizer can't zero out a loaded node.

The fitness functions and GPSO run in torch on the planner's device (the
control plane's stream on a card); the plan comes back to the host in one
fetch, through the caller's ``fetch`` (the control plane counts its own).
The rule-based baselines are numpy, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.gpso import (TorchKey, ga_only_minimize, gpso_minimize,
                                   preemption_risk_cost, slo_violation_cost)
from repro_torch.device import host_to_device, resolve_device


def eq9_fitness(R, ctx):
    """Eq.9 population fitness: R (P, N) -> cost (P,).

    ctx = (node_demand (N,), unit_capacity (N,), replica_cost, lam,
    target_load), f32 tensors. Loads are measured against ``target_load``
    (provisioning headroom); load > 1 (true overload) draws an additional
    quadratic penalty."""
    demand, unit_capacity, replica_cost, lam, target = ctx
    Rr = torch.round(R)                                # integer replicas
    cap = Rr * unit_capacity
    load = demand[None, :] / torch.clamp(cap, min=1e-6)
    # unserved demand (replicas==0 but demand>0) -> strong penalty
    unserved = torch.clamp(demand[None, :] - cap, min=0.0)
    overload = torch.sum(torch.square(torch.clamp(load - 1.0, min=0.0)),
                         dim=-1)
    mean_unit = torch.mean(unit_capacity)
    return (replica_cost * torch.sum(Rr, dim=-1)
            + lam * torch.amax(load / target, dim=-1)
            + 20.0 * overload
            + 50.0 * torch.sum(unserved, dim=-1) / mean_unit)


def eq9_tiered_fitness(R, ctx):
    """Eq.9 extended with the tier-weighted SLO-violation cost term.
    ctx = eq9 ctx ++ (slo_lam, pressure (N,))."""
    demand, unit_capacity, replica_cost, lam, target, slo_lam, pressure = ctx
    Rr = torch.round(R)
    cap = Rr * unit_capacity
    load = demand[None, :] / torch.clamp(cap, min=1e-6)
    base = eq9_fitness(R, (demand, unit_capacity, replica_cost, lam, target))
    return base + slo_lam * slo_violation_cost(load, pressure, target)


def eq9_risk_fitness(R, ctx):
    """Eq.9 extended with the spot preemption-risk cost term.
    ctx = eq9 ctx ++ (risk_lam, risk (N,))."""
    risk_lam, risk = ctx[5], ctx[6]
    return eq9_fitness(R, ctx[:5]) + \
        risk_lam * preemption_risk_cost(torch.round(R), risk)


def eq9_tiered_risk_fitness(R, ctx):
    """Tiered Eq.9 + preemption risk. ctx = eq9 ctx ++ (slo_lam, pressure)
    ++ (risk_lam, risk)."""
    risk_lam, risk = ctx[7], ctx[8]
    return eq9_tiered_fitness(R, ctx[:7]) + \
        risk_lam * preemption_risk_cost(torch.round(R), risk)


@dataclasses.dataclass
class GPSOAutoscaler:
    """The paper's autoscaler: demand forecast -> GPSO plan (Eq.9-11).

    optimizer='ga' drops the PSO refinement. ``plan(slo_pressure=...)``
    switches to the tiered objective. ``key`` is the random key GPSO draws
    from (see ``core.gpso``), split once per plan as the reference splits
    its ``PRNGKey``; by default a ``TorchKey`` from ``seed`` on ``device``."""
    cluster_cfg: "ClusterConfig"
    unit_capacity: float
    seed: int = 0
    optimizer: str = "gpso"          # "gpso" | "ga"
    device: object = "cuda"
    key: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.key is None:
            self.key = TorchKey.from_seed(self.seed, self.device)
        self._last_scale_down = -10**9

    def plan(self, node_demand: np.ndarray, tick: int,
             current: np.ndarray,
             node_speed: Optional[np.ndarray] = None,
             slo_pressure: Optional[np.ndarray] = None,
             preempt_risk: Optional[np.ndarray] = None,
             fetch=None) -> np.ndarray:
        """node_demand: (N,) forecast peak demand per node -> replicas (N,).

        slo_pressure: optional (N,) tier-weighted backlog; when given, the
        plan optimizes the tiered Eq.9 objective. preempt_risk: optional
        (N,) spot-churn signal; when any node is at risk the objective gains
        the preemption-risk cost term. All-zero signals keep the base
        objective. ``fetch`` brings the plan tensor to the host as numpy
        (default: a plain blocking copy)."""
        cfg = self.cluster_cfg
        n = node_demand.shape[0]
        if node_speed is None:
            node_speed = np.ones(n, np.float32)
        self.key, sub = self.key.split(2)
        f32 = np.float32
        host = [np.asarray(node_demand, f32),
                np.asarray(self.unit_capacity * node_speed, f32),
                f32(cfg.replica_cost), f32(cfg.lam), f32(cfg.target_load)]
        fitness = eq9_fitness
        if slo_pressure is not None and np.asarray(slo_pressure).any():
            p = np.asarray(slo_pressure, np.float64)
            p = p / max(p.sum(), 1e-9)       # per-node share, scale-free
            fitness = eq9_tiered_fitness
            host += [f32(cfg.slo_lam), np.asarray(p, f32)]
        if preempt_risk is not None and np.asarray(preempt_risk).any():
            fitness = eq9_tiered_risk_fitness \
                if fitness is eq9_tiered_fitness else eq9_risk_fitness
            host += [f32(getattr(cfg, "risk_lam", 1.0)),
                     np.asarray(preempt_risk, f32)]
        ctx = tuple(host_to_device(a, self.device) for a in host)
        minimize = gpso_minimize if self.optimizer == "gpso" else \
            ga_only_minimize
        best, _, _ = minimize(
            sub, fitness, n, cfg,
            lo=float(cfg.min_replicas_per_node),
            hi=float(cfg.max_replicas_per_node), ctx=ctx)
        best = torch.round(best).to(torch.int32)
        target = fetch(best) if fetch else best.cpu().numpy()
        # scale-down cooldown (flap damping)
        if (target < current).any():
            if tick - self._last_scale_down < cfg.cooldown:
                target = np.maximum(target, current)
            else:
                self._last_scale_down = tick
        return np.clip(target, cfg.min_replicas_per_node,
                       cfg.max_replicas_per_node)


@dataclasses.dataclass
class HPAAutoscaler:
    """Kubernetes Horizontal Pod Autoscaler baseline: per-node
    desired = ceil(current · u / u*), 10% tolerance, stabilization window for
    scale-down (the k8s defaults, scaled to sim ticks)."""
    cluster_cfg: "ClusterConfig"
    target_utilization: float = 0.6
    tolerance: float = 0.1
    window: int = 30

    def __post_init__(self):
        self._history: list = []

    def plan(self, utilization: np.ndarray, tick: int,
             current: np.ndarray) -> np.ndarray:
        cfg = self.cluster_cfg
        ratio = utilization / self.target_utilization
        desired = np.ceil(current * np.where(
            np.abs(ratio - 1.0) > self.tolerance, ratio, 1.0)).astype(np.int32)
        desired = np.maximum(desired, 1)
        self._history.append(desired)
        if len(self._history) > self.window:
            self._history.pop(0)
        # scale down only to the max desired over the stabilization window
        floor = np.max(np.stack(self._history), axis=0)
        desired = np.where(desired < current, np.minimum(floor, current),
                           desired)
        return np.clip(desired, cfg.min_replicas_per_node,
                       cfg.max_replicas_per_node)


@dataclasses.dataclass
class RBASAutoscaler:
    """Rule-Based Auto-Scaling baseline: threshold rules + cooldown."""
    cluster_cfg: "ClusterConfig"
    hi: float = 0.8
    lo: float = 0.3
    patience: int = 3
    cooldown: int = 20

    def __post_init__(self):
        self._over = None
        self._under = None
        self._last_action = -10**9

    def plan(self, utilization: np.ndarray, tick: int,
             current: np.ndarray) -> np.ndarray:
        cfg = self.cluster_cfg
        n = utilization.shape[0]
        if self._over is None:
            self._over = np.zeros(n, np.int32)
            self._under = np.zeros(n, np.int32)
        self._over = np.where(utilization > self.hi, self._over + 1, 0)
        self._under = np.where(utilization < self.lo, self._under + 1, 0)
        target = current.copy()
        if tick - self._last_action >= self.cooldown:
            up = self._over >= self.patience
            down = self._under >= self.patience
            if up.any() or down.any():
                target = current + up.astype(np.int32) - down.astype(np.int32)
                self._last_action = tick
                self._over[:] = 0
                self._under[:] = 0
        return np.clip(target, max(cfg.min_replicas_per_node, 1),
                       cfg.max_replicas_per_node)


@dataclasses.dataclass
class StaticAllocator:
    """No autoscaling (fixed replicas) — RRA/LCA rows in the paper's figures."""
    replicas: int = 4

    def plan(self, utilization, tick, current):
        return np.full_like(current, self.replicas)
