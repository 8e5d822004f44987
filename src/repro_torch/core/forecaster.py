"""Demand forecasting DNN (the paper's deep-learning component of S_t); the
port of ``repro.core.forecaster``.

GRU over a window of recent per-node load, predicting the next-T horizon
R̂_{t+1:t+T} (Eq. 1). Trained with MSE on trace windows (``train_forecaster``,
the reference's hand-written Adam); a last-value baseline is provided too,
which the serve path uses. Parameters are dicts of tensors
(``init_forecaster`` from a ``torch.Generator``, or the reference's through
``repro_torch.bridge.forecaster_from_jax``). The GRU runs eagerly, one step
of the window at a time (the reference scans it under ``jit``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tree import tree_map, value_and_grad
from repro_torch.device import host_to_device, resolve_device
from repro_torch.models.layers import he_init


def init_gru(generator, in_dim: int, hidden: int) -> dict:
    dev = generator.device
    zeros = lambda: torch.zeros((hidden,), dtype=torch.float32, device=dev)
    return {
        "wz": he_init(generator, (in_dim + hidden, hidden), torch.float32),
        "wr": he_init(generator, (in_dim + hidden, hidden), torch.float32),
        "wh": he_init(generator, (in_dim + hidden, hidden), torch.float32),
        "bz": zeros(), "br": zeros(), "bh": zeros(),
    }


def gru_step(p, h, x):
    xh = torch.cat([x, h], dim=-1)
    z = torch.sigmoid(xh @ p["wz"] + p["bz"])
    r = torch.sigmoid(xh @ p["wr"] + p["br"])
    xrh = torch.cat([x, r * h], dim=-1)
    h_new = torch.tanh(xrh @ p["wh"] + p["bh"])
    return (1 - z) * h + z * h_new


def init_forecaster(generator, in_dim: int, hidden: int,
                    horizon: int) -> dict:
    return {
        "gru": init_gru(generator, in_dim, hidden),
        "head": he_init(generator, (hidden, horizon * in_dim), torch.float32),
        "head_b": torch.zeros((horizon * in_dim,), dtype=torch.float32,
                              device=generator.device),
    }


def forecast(params, window):
    """window: (..., W, F) past loads -> (..., T, F) predicted horizon."""
    lead = tuple(window.shape[:-2])
    F = window.shape[-1]
    h = window.new_zeros(lead + (params["gru"]["bz"].shape[0],))
    for x in window.unbind(dim=-2):
        h = gru_step(params["gru"], h, x)
    out = h @ params["head"] + params["head_b"]
    return out.reshape(lead + (out.shape[-1] // F, F))


def forecast_loss(params, window, target):
    pred = forecast(params, window)
    return torch.mean(torch.square(pred - target))


def last_value_baseline(window, horizon: int):
    """Persistence forecast: repeat the last observation."""
    last = window[..., -1:, :]
    return last.expand(*last.shape[:-2], horizon, last.shape[-1]).clone()


def train_forecaster(key, windows, targets, hidden: int, *, steps=500,
                     lr=1e-2, batch=64, params=None, device="cuda"):
    """windows: (M, W, F); targets: (M, T, F) (numpy). Returns (params,
    losses). ``key`` is a random key as in ``core.gpso`` (``TorchKey``):
    each step splits it and draws the step's batch indices from the child,
    where the reference draws from ``jax.random``. ``params`` are the
    initial parameters (default: ``init_forecaster`` from the key's
    generator). Adam as the reference writes it; the losses are fetched
    once, at the end."""
    dev = resolve_device(device)
    windows = host_to_device(np.asarray(windows, np.float32), dev)
    targets = host_to_device(np.asarray(targets, np.float32), dev)
    M, W, F = windows.shape
    if params is None:
        params = init_forecaster(key.generator(), F, hidden,
                                 targets.shape[1])
    mu = tree_map(torch.zeros_like, params)
    nu = tree_map(torch.zeros_like, params)
    losses = []
    for i in range(steps):
        key, sub = key.split(2)
        idx = sub.randint((batch,), 0, M).to(dev)
        loss, grads = value_and_grad(
            lambda p: forecast_loss(p, windows[idx], targets[idx]), params)
        mu = tree_map(lambda m, g: 0.9 * m + 0.1 * g, mu, grads)
        nu = tree_map(lambda v, g: 0.999 * v + 0.001 * g * g, nu, grads)
        t = np.float32(i + 1.0)
        c1 = float(np.float32(1.0) - np.float32(0.9) ** t)
        c2 = float(np.float32(1.0) - np.float32(0.999) ** t)
        params = tree_map(
            lambda p, m, v: p - lr * (m / c1) / (torch.sqrt(v / c2) + 1e-8),
            params, mu, nu)
        losses.append(loss)
    return params, torch.stack(losses).cpu().tolist() if losses else []
