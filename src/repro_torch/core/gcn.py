"""Graph Convolutional Network over the cluster topology (paper Eq. 6); the
port of ``repro.core.gcn``.

H^{l+1} = σ( D̃^{-1/2} Ã D̃^{-1/2} H^l W^l ),  Ã = A + I.

The normalized adjacency is precomputed once per topology (numpy). Inputs
are (N, F) node-feature matrices or batched (..., N, F). Every layer of
``gcn_apply`` runs through ``ops.gcn_layer``: the hand-written CUDA kernel
on a CUDA tensor, its plain version on a CPU tensor. The reference computes
the same function as an XLA einsum; its Pallas kernel is held to that.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import he_init


def make_topology(n: int, kind: str = "ring+hub") -> np.ndarray:
    """Adjacency matrix (no self loops — Eq.6 adds I itself)."""
    A = np.zeros((n, n), np.float32)
    if kind in ("ring", "ring+hub"):
        for i in range(n):
            A[i, (i + 1) % n] = A[(i + 1) % n, i] = 1.0
    if kind in ("star", "ring+hub"):
        A[0, 1:] = A[1:, 0] = 1.0
    if kind == "full":
        A = np.ones((n, n), np.float32) - np.eye(n, dtype=np.float32)
    return A


def normalize_adjacency(A: np.ndarray) -> np.ndarray:
    """D̃^{-1/2} (A+I) D̃^{-1/2}."""
    A_t = A + np.eye(A.shape[0], dtype=A.dtype)
    d = A_t.sum(axis=1)
    d_inv_sqrt = 1.0 / np.sqrt(np.maximum(d, 1e-9))
    return (A_t * d_inv_sqrt[:, None]) * d_inv_sqrt[None, :]


def init_gcn(generator: torch.Generator, in_dim: int, hidden: int,
             n_layers: int, out_dim: int = 0) -> dict:
    """He-normal weights from ``generator`` (on its device), zero biases."""
    dims = [in_dim] + [hidden] * (n_layers - 1) + [out_dim or hidden]
    dev = generator.device
    return {
        "w": [he_init(generator, (dims[i], dims[i + 1]), torch.float32)
              for i in range(len(dims) - 1)],
        "b": [torch.zeros((dims[i + 1],), dtype=torch.float32, device=dev)
              for i in range(len(dims) - 1)],
    }


def gcn_apply(params, a_hat, x, final_activation=None):
    """x: (..., N, F) -> (..., N, H). a_hat: (N, N) normalized adjacency.
    Inner layers apply the relu inside the kernel; the last layer applies
    ``final_activation`` if one is given."""
    lead = x.shape[:-2]
    h = x.reshape((-1,) + tuple(x.shape[-2:])) if len(lead) > 1 else x
    n_layers = len(params["w"])
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        h = ops.gcn_layer(a_hat, h, w, b, relu=i < n_layers - 1)
    if final_activation is not None:
        h = final_activation(h)
    return h.reshape(tuple(lead) + tuple(h.shape[-2:]))
