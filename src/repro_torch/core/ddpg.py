"""GCN+DDPG hybrid policy for adaptive load distribution (paper §3.1); the
acting half of ``repro.core.ddpg``.

Actor: node features --GCN(Eq.6)--> per-node embeddings --shared MLP-->
per-node logits --softmax--> simplex allocation A_t (Eq.4/7). The shared
per-node head is the paper's "shared policy network with local information
fusion": every agent (node) runs the same head on its GCN-fused local view.

Critic: Q(S_t, A_t) — GCN embeddings concat per-node action, shared MLP,
summed over nodes (permutation-equivariant).

The greedy action runs as one launch of the GCN kernel (``ops.gcn_actor``)
or layered; ``RLBalancer`` chooses once, from the graph's size. Parameters
are nested dicts of tensors. ``init_*`` draw them from a
``torch.Generator``; ``repro_torch.bridge.rl_from_jax`` carries the
reference's across instead.

Training (``ddpg_update``, Eq.8) is the reference's step: one TD step of
the critic and one policy-gradient step of the actor, each a plain SGD step
``p - lr·g`` on gradients clipped to norm 1, then polyak target updates.
Gradients through the GCN come from ``core.gcn.GCNLayer``, whose backward
is the ``gcn_layer_bwd`` kernel on the card. Nothing in the update reads a
value back to the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.gcn import gcn_apply, init_gcn
from repro_torch.core.tree import leaves, tree_map, value_and_grad
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
    return tree_map(lambda t: t.clone(), tree)


def polyak(target, online, tau):
    return tree_map(lambda t, o: (1 - tau) * t + tau * o, target, online)


def clip_by_norm(grads, max_norm=1.0):
    """Scale a gradient tree to global norm at most ``max_norm`` (on the
    device: the norm is never read back)."""
    g2 = sum(torch.sum(torch.square(g)) for g in leaves(grads))
    scale = torch.clamp(max_norm / torch.clamp(torch.sqrt(g2), min=1e-9),
                        max=1.0)
    return tree_map(lambda g: g * scale, grads)


def init_ddpg(generator, feat_dim, cfg) -> DDPGState:
    actor = init_actor(generator, feat_dim, cfg)
    critic = init_critic(generator, feat_dim, cfg)
    return DDPGState(actor, critic, _clone(actor), _clone(critic))


def ddpg_update(state_tuple, a_hat, batch, *, gamma, tau, actor_lr,
                critic_lr, fused_target=True):
    """One TD + policy-gradient step (Eq.8). state_tuple = (actor, critic,
    actor_t, critic_t); batch = (obs, act, rew, nxt, mask), tensors on
    a_hat's device. Returns the new tuple and the losses (0-d tensors, not
    fetched).

    GCN launches on the card (L GCN layers): the target action, one fused
    ``gcn_actor`` launch (``fused_target``; else L layered); the target,
    online and actor-loss critics and the actor's action, L ``gcn_layer``
    launches each; L ``gcn_layer_bwd`` launches for the critic's gradient
    and L for the actor's (dX on all layers but the first, whose input is
    the observation). The critic's GCN in the actor loss takes no gradient:
    its parameters are held constant there, as the reference's are."""
    actor, critic, actor_t, critic_t = state_tuple
    obs, act, rew, nxt, mask = batch

    with torch.no_grad():
        next_a = actor_action(actor_t, a_hat, nxt, up_mask=mask,
                              fused=fused_target)
        target_q = rew + gamma * critic_q(critic_t, a_hat, nxt, next_a)

    def critic_loss(c):
        q = critic_q(c, a_hat, obs, act)
        return torch.mean(torch.square(q - target_q))

    c_loss, c_grads = value_and_grad(critic_loss, critic)
    c_grads = clip_by_norm(c_grads)
    critic = tree_map(lambda p, g: p - critic_lr * g, critic, c_grads)

    def actor_loss(a):
        action = actor_action(a, a_hat, obs, up_mask=mask, fused=False)
        return -torch.mean(critic_q(critic, a_hat, obs, action))

    a_loss, a_grads = value_and_grad(actor_loss, actor)
    a_grads = clip_by_norm(a_grads)
    actor = tree_map(lambda p, g: p - actor_lr * g, actor, a_grads)

    actor_t = polyak(actor_t, actor, tau)
    critic_t = polyak(critic_t, critic, tau)
    return (actor, critic, actor_t, critic_t), {"critic_loss": c_loss,
                                                "actor_loss": a_loss}
