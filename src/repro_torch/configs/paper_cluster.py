"""The paper's control-plane experiment configuration (§4.1); a copy of
``repro.configs.paper_cluster``.

Cluster of N serving nodes managed by the MADRL balancer + GPSO autoscaler,
driven by a Google-Cluster-Data-style synthetic trace. Hyperparameters the
paper leaves unspecified are recorded here (see DESIGN.md §8).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    num_nodes: int = 16              # serving nodes (replica groups)
    topology: str = "ring+hub"       # adjacency for the GCN (ring + controller hub)
    horizon: int = 32                # forecast horizon T (ticks) in S_t
    #   (≥ provisioning_delay so proactive scaling can beat the cold start)
    tick_seconds: float = 1.0
    # --- Eq.5 reward weights ---
    alpha: float = 1.0               # response-time weight
    beta: float = 0.25               # resource (idle/overload) cost weight
    slo_gamma: float = 0.5           # tier-weighted SLO-violation weight
    #   (scales metrics['tier_slo_cost'] in the reward; inert when untiered)
    # --- node economics ---
    base_capacity: float = 100.0     # requests/sec per replica (scaled by arch cost)
    max_replicas_per_node: int = 8
    min_replicas_per_node: int = 0
    replica_cost: float = 1.0        # C_i in Eq.9 (per replica-tick)
    provisioning_delay: int = 30     # ticks before a new replica serves (cold start)
    # --- failure model ---
    node_mtbf: float = 20_000.0      # mean ticks between node failures
    node_mttr: float = 120.0         # mean ticks to recover
    straggler_prob: float = 0.02     # steady-state fraction of degraded nodes
    straggler_slowdown: float = 0.35 # capacity multiplier when degraded
    straggler_mean_ticks: float = 20.0  # mean degradation episode length
    # --- GCN/DDPG (sizes unspecified in paper; chosen small, swept in tests) ---
    gcn_layers: int = 2
    gcn_hidden: int = 64
    actor_hidden: int = 128
    critic_hidden: int = 128
    gamma: float = 0.95
    tau: float = 0.01                # polyak
    actor_lr: float = 1e-4
    critic_lr: float = 1e-3
    buffer_size: int = 50_000
    batch_size: int = 128
    noise_sigma: float = 0.1         # exploration noise N_t (Eq.7)
    # --- GPSO (Eq.9-11) ---
    lam: float = 32.0                # λ cost/load balance weight in Eq.9
    target_load: float = 0.7         # provisioning headroom (L_i target)
    slo_lam: float = 8.0             # tier-weighted SLO-violation cost weight
    #   (the Eq.9 extension used when the backend reports tier_pressure)
    risk_lam: float = 4.0            # spot preemption-risk cost weight
    #   (the Eq.9 extension used when the backend reports preempt_risk;
    #    inert while the risk signal is all zeros)
    ga_pop: int = 64
    ga_generations: int = 20
    ga_elite: int = 16
    ga_crossover: float = 0.8
    ga_mutation: float = 0.08
    pso_iters: int = 30
    pso_inertia: float = 0.6         # w
    pso_c1: float = 1.4
    pso_c2: float = 1.4
    # --- forecaster ---
    forecast_window: int = 64
    forecast_hidden: int = 64
    # --- autoscaler policy ---
    scale_interval: int = 10         # run GPSO every k ticks
    cooldown: int = 30               # min ticks between scale-downs


DEFAULT = ClusterConfig()
