"""Decentralized decision layer, single-device half: gossip policy sync and
gradient compression (the port of ``repro.core.decentralized``).

  1. ``gossip_average``: symmetric-mixing gossip over the topology; each
     round shrinks the disagreement. It keeps per-node policy replicas
     consistent without a central parameter server.
  2. ``topk_compress`` / ``ErrorFeedback``: top-k sparsification with an
     error-feedback residual for the policy-sync traffic (sync bytes drop
     ~50-100x; the residual keeps convergence).

A node tree is a parameter tree (``core.tree``) whose every leaf has a
leading node axis. The collective half (``psum_average_grads``,
``make_gossip_allreduce``) runs across devices and is not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.tree import leaves, tree_map


def mixing_matrix(adjacency: np.ndarray) -> np.ndarray:
    """Metropolis-Hastings weights: doubly stochastic, symmetric (numpy
    f32, the reference's arithmetic)."""
    A = np.asarray(adjacency, np.float64)
    n = A.shape[0]
    deg = A.sum(1)
    W = np.zeros_like(A)
    for i in range(n):
        for j in range(n):
            if i != j and A[i, j] > 0:
                W[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
        W[i, i] = 1.0 - W[i].sum()
    return W.astype(np.float32)


def gossip_average(node_params, W, rounds: int = 1):
    """``rounds`` rounds of x <- W x over the node axis of every leaf.
    ``W`` (N, N): numpy or a tensor."""
    def mix(x):
        w = torch.as_tensor(W, dtype=x.dtype, device=x.device)
        for _ in range(rounds):
            x = torch.einsum("nm,m...->n...", w, x)
        return x
    return tree_map(mix, node_params)


def disagreement(node_params) -> float:
    """Max L2 distance of any node's params from the mean (the consensus
    gap); read back to the host."""
    gaps = []
    for x in leaves(node_params):
        dev = x - x.mean(dim=0, keepdim=True)
        gaps.append(torch.sqrt(torch.square(dev).sum(
            dim=tuple(range(1, x.dim())))).max())
    return float(torch.stack(gaps).max())


def topk_compress(x, k_frac: float):
    """Keep the top ``k_frac`` of |x|'s entries: (sparse x, kept mask)."""
    flat = x.reshape(-1)
    k = max(1, int(flat.shape[0] * k_frac))
    idx = torch.topk(flat.abs(), k).indices
    mask = torch.zeros_like(flat).index_fill_(0, idx, 1.0)
    return (flat * mask).reshape(x.shape), mask.reshape(x.shape)


@dataclasses.dataclass
class ErrorFeedback:
    """EF-SGD residual accumulator for compressed collectives."""
    k_frac: float = 0.02

    def init(self, params):
        return tree_map(torch.zeros_like, params)

    def compress(self, grads, residual):
        """(compressed grads to transmit, new residual)."""
        corrected = tree_map(lambda g, r: g + r, grads, residual)
        sparse = tree_map(lambda c: topk_compress(c, self.k_frac)[0],
                          corrected)
        return sparse, tree_map(lambda c, s: c - s, corrected, sparse)
