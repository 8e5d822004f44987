"""Load balancers: the paper's MADRL(GCN+DDPG) policy + the §4.2 baselines
(the port of ``repro.core.balancer``).

Every balancer maps per-tick cluster observations to a simplex allocation
a_t over nodes (Eq. 4): fractions of the tick's request mass per node; in
the request-level serving engine the fractions drive per-request routing.

Baselines (paper §4.2): RRA (round robin -> uniform over healthy nodes),
LCA (least connections -> water-filling on queue depth, capacity-blind),
plus WRR (capacity-weighted) as an extra reference. All take and return
tensors; the control plane runs them on its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import ddpg
from repro_torch.core.gcn import make_topology, normalize_adjacency
from repro_torch.device import host_to_device, resolve_device


def _mask_normalize(w, up_mask):
    w = torch.where(up_mask > 0, w, 0.0)
    s = torch.sum(w, dim=-1, keepdim=True)
    n_up = torch.sum(up_mask, dim=-1, keepdim=True)
    uniform = up_mask / torch.clamp(n_up, min=1.0)
    return torch.where(s > 1e-9, w / torch.clamp(s, min=1e-9), uniform)


def round_robin(obs, up_mask):
    """RRA: uniform over healthy nodes (per-request RR in the fluid limit)."""
    return _mask_normalize(torch.ones_like(up_mask), up_mask)


def weighted_capacity(obs, up_mask, capacity):
    """WRR: fractions ∝ node capacity."""
    return _mask_normalize(capacity, up_mask)


def least_connections(queue, up_mask, total_arrivals):
    """LCA as water-filling: route this tick's arrivals so post-routing queue
    depths equalize from the bottom up (what per-request least-connections
    converges to within a tick). Capacity-blind, like the real algorithm.

    queue: (N,) outstanding work; total_arrivals: scalar mass to place.
    """
    N = queue.shape[-1]
    big = 1e18
    q = torch.where(up_mask > 0, queue, big)
    order = torch.argsort(q, stable=True)
    qs = q[order]
    # find water level L: sum_i max(0, L - q_i) = total => for first k nodes
    csum = torch.cumsum(qs, dim=0)
    k = torch.arange(1, N + 1, device=q.device)
    level = (csum + total_arrivals) / k        # candidate level, k lowest
    next_q = torch.cat([qs[1:], torch.full((1,), big, device=q.device)])
    feasible = (level >= qs) & (level <= next_q)
    k_star = torch.argmax(feasible.to(torch.int32), dim=0,
                          keepdim=True)       # first feasible k, on device
    L = level[k_star]
    ks = torch.arange(N, device=q.device)
    alloc_sorted = torch.clamp(L - qs, min=0.0) * (ks <= k_star)
    alloc = torch.zeros_like(q)
    alloc[order] = alloc_sorted
    alloc = torch.where(up_mask > 0, alloc, 0.0)
    s = torch.sum(alloc)
    return torch.where(s > 1e-9, alloc / torch.clamp(s, min=1e-9),
                       _mask_normalize(torch.ones_like(q), up_mask))


@dataclasses.dataclass
class RLBalancer:
    """The paper's balancer: GCN+DDPG actor producing A_t from S_t, on
    ``device``. ``state`` is the actor/critic parameters: given (e.g. the
    reference's, through ``repro_torch.bridge.rl_from_jax``), or drawn from
    a ``torch.Generator`` seeded with ``seed``. Acting greedily runs the
    whole action as one launch of the GCN kernel (``actor`` "fused") when
    the topology's graph fits one block (``ddpg.actor_fits``), else
    "layered": both GCN layers through the ``gcn_layer`` kernel, the head
    as eager ops. ``layered=True`` forces the latter (the A/B against the
    fused path). ``train_step`` runs one ``ddpg.ddpg_update`` on a batch
    sampled from the numpy replay buffer by ``_rng`` -- the generator the
    exploration noise comes from, drawn in the reference's order -- and
    fetches its two losses in one device-to-host copy (``fetches``)."""
    cluster_cfg: "ClusterConfig"
    feat_dim: int
    seed: int = 0
    device: object = "cuda"
    state: ddpg.DDPGState = None
    layered: bool = False

    def __post_init__(self):
        cfg = self.cluster_cfg
        self.device = resolve_device(self.device)
        self.a_hat = host_to_device(normalize_adjacency(
            make_topology(cfg.num_nodes, cfg.topology)), self.device)
        if self.state is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            self.state = ddpg.init_ddpg(gen, self.feat_dim, cfg)
        fits = ddpg.actor_fits(self.state.actor, cfg.num_nodes,
                               self.feat_dim)
        self.actor = "fused" if fits and not self.layered else "layered"
        self.buffer = ddpg.ReplayBuffer(cfg.buffer_size, cfg.num_nodes,
                                        self.feat_dim)
        self._rng = np.random.default_rng(self.seed)
        self.fetches = 0

    # -- acting ---------------------------------------------------------
    def act(self, obs, up_mask, explore: bool = False):
        """obs (N, F), up_mask (N,) tensors on ``device`` -> fractions (N,)
        on ``device`` (not fetched)."""
        noise = None
        if explore:
            noise = torch.from_numpy(np.asarray(self._rng.normal(
                0.0, self.cluster_cfg.noise_sigma, tuple(obs.shape[:-1])),
                np.float32)).to(self.device)
        return ddpg.actor_action(self.state.actor, self.a_hat, obs,
                                 up_mask=up_mask, noise=noise,
                                 fused=self.actor == "fused")

    # -- learning -------------------------------------------------------
    def observe(self, obs, action, reward, next_obs, up_mask):
        self.buffer.add(np.asarray(obs), np.asarray(action), float(reward),
                        np.asarray(next_obs), np.asarray(up_mask))

    def train_step(self):
        cfg = self.cluster_cfg
        if self.buffer.size < cfg.batch_size:
            return {}
        batch = tuple(host_to_device(a, self.device) for a in
                      self.buffer.sample(self._rng, cfg.batch_size))
        tup = (self.state.actor, self.state.critic,
               self.state.actor_target, self.state.critic_target)
        tup, metrics = ddpg.ddpg_update(
            tup, self.a_hat, batch, gamma=cfg.gamma, tau=cfg.tau,
            actor_lr=cfg.actor_lr, critic_lr=cfg.critic_lr,
            fused_target=self.actor == "fused")
        self.state = ddpg.DDPGState(*tup)
        losses = torch.stack(list(metrics.values())).cpu().tolist()
        self.fetches += 1
        return dict(zip(metrics, losses))


def reward_fn(response_time, utilization, alpha, beta, overload,
              slo_cost: float = 0.0):
    """Eq.5: R_t = -(α·ResponseTime + β·(idle-capacity + overload penalty)
    + tier-weighted SLO cost). Response time enters through log1p so
    transient queue blow-ups cannot destabilize the critic."""
    idle_cost = 1.0 - utilization
    rt_cost = float(np.log1p(response_time))
    return -(alpha * rt_cost + beta * (idle_cost + 2.0 * overload)
             + float(slo_cost))
