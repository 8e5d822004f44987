"""Graph Convolutional Network over the cluster topology (paper Eq. 6); the
port of ``repro.core.gcn``.

H^{l+1} = σ( D̃^{-1/2} Ã D̃^{-1/2} H^l W^l ),  Ã = A + I.

The normalized adjacency is precomputed once per topology (numpy). Inputs
are (N, F) node-feature matrices or batched (..., N, F). Every layer of
``gcn_apply`` runs through ``ops.gcn_layer``: the hand-written CUDA kernel
on a CUDA tensor, its plain version on a CPU tensor. The reference computes
the same function as an XLA einsum; its Pallas kernel is held to that.

When a gradient is needed (the DDPG update) each layer runs as
``GCNLayer``, an autograd function whose forward is ``ops.gcn_layer`` and
whose backward is ``ops.gcn_layer_bwd``: the backward kernel on the card,
autograd through the plain version on the CPU. The reference's Pallas
kernel has no VJP; it differentiates its plain XLA GCN.
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


class GCNLayer(torch.autograd.Function):
    """One GCN layer with its gradient: forward ``ops.gcn_layer``, backward
    ``ops.gcn_layer_bwd`` (dX only when x needs it). a_hat takes no
    gradient."""

    @staticmethod
    def forward(ctx, a_hat, x, w, b, relu):
        out = ops.gcn_layer(a_hat, x, w, b, relu=relu)
        ctx.save_for_backward(a_hat, x, w, b, out)
        ctx.relu = relu
        return out

    @staticmethod
    def backward(ctx, dh):
        a_hat, x, w, b, out = ctx.saved_tensors
        dx, dw, db = ops.gcn_layer_bwd(a_hat, x, w, b, out, dh.contiguous(),
                                       relu=ctx.relu,
                                       need_dx=ctx.needs_input_grad[1])
        return None, dx, dw, db, None


def gcn_apply(params, a_hat, x, activation=None, final_activation=None):
    """x: (..., N, F) -> (..., N, H). a_hat: (N, N) normalized adjacency.
    Inner layers apply ``activation`` (None: relu, the reference's default
    ``jax.nn.relu``); the last layer applies ``final_activation`` if one is
    given. Under relu the inner layers' relu runs inside the kernel; any
    other activation runs after a kernel launched with ``relu=False``.
    Layers run as ``GCNLayer`` when autograd records and x or a layer's
    weights need a gradient."""
    lead = x.shape[:-2]
    h = x.reshape((-1,) + tuple(x.shape[-2:])) if len(lead) > 1 else x
    n_layers = len(params["w"])
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        inner = i < n_layers - 1
        relu = inner and activation is None
        if torch.is_grad_enabled() and (h.requires_grad or w.requires_grad
                                        or b.requires_grad):
            h = GCNLayer.apply(a_hat, h, w, b, relu)
        else:
            h = ops.gcn_layer(a_hat, h, w, b, relu=relu)
        if inner and activation is not None:
            h = activation(h)
    if final_activation is not None:
        h = final_activation(h)
    return h.reshape(tuple(lead) + tuple(h.shape[-2:]))
