"""Demand forecasting DNN (the paper's deep-learning component of S_t); the
port of ``repro.core.forecaster``'s inference half.

GRU over a window of recent per-node load, predicting the next-T horizon
R̂_{t+1:t+T} (Eq. 1). A last-value baseline is provided too; the serve path
runs without a trained forecaster and uses it. Parameters are dicts of
tensors (``init_forecaster`` from a ``torch.Generator``, or the reference's
through ``repro_torch.bridge.forecaster_from_jax``). Training
(``train_forecaster``) belongs to a later slice of the port.
"""
from __future__ import annotations

import torch

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


def last_value_baseline(window, horizon: int):
    """Persistence forecast: repeat the last observation."""
    last = window[..., -1:, :]
    return last.expand(*last.shape[:-2], horizon, last.shape[-1]).clone()


def train_forecaster(*args, **kwargs):
    """Forecaster training belongs to the training slice."""
    raise NotImplementedError("train_forecaster is not yet ported")
