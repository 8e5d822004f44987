"""GCN+DDPG hybrid policy for adaptive load distribution (paper §3.1); the
acting half of ``repro.core.ddpg``.

Actor: node features --GCN(Eq.6)--> per-node embeddings --shared MLP-->
per-node logits --softmax--> simplex allocation A_t (Eq.4/7). The shared
per-node head is the paper's "shared policy network with local information
fusion": every agent (node) runs the same head on its GCN-fused local view.

Critic: Q(S_t, A_t) — GCN embeddings concat per-node action, shared MLP,
summed over nodes (permutation-equivariant).

The greedy action runs as one launch of the GCN kernel (``ops.gcn_actor``)
or layered; ``RLBalancer`` chooses once, from the graph's size. Parameters are nested dicts
of tensors. ``init_*`` draw them from a ``torch.Generator``;
``repro_torch.bridge.rl_from_jax`` carries the reference's across instead.
Training (``ddpg_update``) belongs to a later slice of the port: the serve
path acts greedily and never trains.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.gcn import gcn_apply, init_gcn
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import he_init


def init_mlp_head(generator, in_dim, hidden, out_dim, final_scale=1.0):
    dev = generator.device
    return {
        "w1": he_init(generator, (in_dim, hidden), torch.float32),
        "b1": torch.zeros((hidden,), dtype=torch.float32, device=dev),
        "w2": he_init(generator, (hidden, out_dim), torch.float32)
        * final_scale,
        "b2": torch.zeros((out_dim,), dtype=torch.float32, device=dev),
    }


def mlp_head(p, x):
    return torch.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def init_actor(generator, feat_dim, cfg) -> dict:
    return {
        "gcn": init_gcn(generator, feat_dim, cfg.gcn_hidden, cfg.gcn_layers),
        "head": init_mlp_head(generator, cfg.gcn_hidden + feat_dim,
                              cfg.actor_hidden, 1, final_scale=0.01),
    }


def init_critic(generator, feat_dim, cfg) -> dict:
    return {
        "gcn": init_gcn(generator, feat_dim, cfg.gcn_hidden, cfg.gcn_layers),
        "head": init_mlp_head(generator, cfg.gcn_hidden + feat_dim + 1,
                              cfg.critic_hidden, 1),
    }


def actor_fits(params, n_nodes: int, feat_dim: int) -> bool:
    """Whether ``ops.gcn_actor`` takes this actor over ``n_nodes`` nodes of
    ``feat_dim`` features in one launch."""
    ws = params["gcn"]["w"]
    return ops.gcn_actor_fits(n_nodes, feat_dim, max(w.shape[1] for w in ws),
                              params["head"]["w1"].shape[1], len(ws))


def actor_action(params, a_hat, obs, up_mask=None, noise=None, fused=True):
    """Simplex allocation over nodes (Eq.4). Noise (Eq.7) added to logits.

    up_mask: (..., N) 1 for healthy nodes — failed nodes get zero traffic.
    ``fused`` runs the whole action as one ``ops.gcn_actor`` launch (on a
    card the graph must fit one block: ``actor_fits``, else it raises);
    False runs it layered: each GCN layer through ``ops.gcn_layer``, then
    the head, mask and softmax as eager ops. The caller chooses
    (``RLBalancer``, once).
    """
    if fused:
        return ops.gcn_actor(a_hat, obs, params["gcn"], params["head"],
                             up_mask=up_mask, noise=noise)
    h = gcn_apply(params["gcn"], a_hat, obs)
    return ref.actor_head_ref(h, obs, params["head"], up_mask, noise)


def critic_q(params, a_hat, obs, action):
    """Q(S_t, A_t): (..., N, F), (..., N) -> (...)."""
    h = gcn_apply(params["gcn"], a_hat, obs)
    h = torch.cat([h, obs, action[..., None]], dim=-1)
    q = mlp_head(params["head"], h)[..., 0]    # per-node q contribution
    return torch.sum(q, dim=-1)


@dataclasses.dataclass
class ReplayBuffer:
    """Numpy ring buffer of (obs, action, reward, next_obs, up_mask)."""
    capacity: int
    n_nodes: int
    feat_dim: int

    def __post_init__(self):
        C, N, F = self.capacity, self.n_nodes, self.feat_dim
        self.obs = np.zeros((C, N, F), np.float32)
        self.act = np.zeros((C, N), np.float32)
        self.rew = np.zeros((C,), np.float32)
        self.nxt = np.zeros((C, N, F), np.float32)
        self.mask = np.ones((C, N), np.float32)
        self.size = 0
        self.ptr = 0

    def add(self, obs, act, rew, nxt, mask):
        i = self.ptr
        self.obs[i], self.act[i], self.rew[i] = obs, act, rew
        self.nxt[i], self.mask[i] = nxt, mask
        self.ptr = (i + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)

    def sample(self, rng: np.random.Generator, batch: int):
        idx = rng.integers(0, self.size, size=batch)
        return (self.obs[idx], self.act[idx], self.rew[idx], self.nxt[idx],
                self.mask[idx])


@dataclasses.dataclass
class DDPGState:
    actor: dict
    critic: dict
    actor_target: dict
    critic_target: dict


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def init_ddpg(generator, feat_dim, cfg) -> DDPGState:
    actor = init_actor(generator, feat_dim, cfg)
    critic = init_critic(generator, feat_dim, cfg)
    return DDPGState(actor, critic, _clone(actor), _clone(critic))


def ddpg_update(*args, **kwargs):
    """The TD + policy-gradient step (Eq.8) belongs to the training slice."""
    raise NotImplementedError("ddpg_update (DDPG training) is not yet ported")
