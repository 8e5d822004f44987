"""``ControlPlane``: the paper's forecast -> balance -> scale loop over any
``ClusterBackend`` (the port of ``repro.control.plane``).

Per tick (Eq.1-11):

    1. demand forecast R̂_{t+1:t+T} over a rolling arrivals window: the GRU
       when a trained forecaster is given, last-value persistence otherwise,
    2. balancer action a_t (MADRL GCN+DDPG, or the RRA/LCA/WRR baselines),
    3. backend advances one dt under a_t,
    4. RL reward/replay (optional training: with ``train_rl`` the plane
       stores each transition and runs a DDPG update every
       ``train_every`` ticks),
    5. autoscaling: GPSO replans every ``scale_interval`` ticks with
       volatility-aware headroom + an instantaneous-overload emergency path;
       the HPA/RBAS rule baselines observe every tick.

**Where it runs.** The plane's device work -- the GCN actor (both layers
through the ``gcn_layer`` kernel), its DDPG updates, the tensor balancers,
the GRU forecast and GPSO -- runs on
``device`` (default ``"cuda"``). On a card it runs on a CUDA stream of its
own: the backend's decode runs on the default stream, and the fractions and
the plan the plane fetches to the host then wait only for the plane's own
work, never for the decode queued behind it, so the forecast -> balance ->
scale work overlaps the device's decode under the elastic frontend's async
tick. The observation, the window and the metrics stay numpy, as in the
reference.

**Accounting.** ``host_s`` sums the host seconds of each phase (forecast,
balance, learn -- the replay and the DDPG updates --, scale), each the
seconds of the phase's span (``plane.forecast``, ``plane.balance``,
``plane.learn``, ``plane.scale``; ``repro_torch.telemetry``);
``fetches`` / ``fetch_wait`` count the plane's blocking device-to-host
fetches (the GRU forecast, the fractions, and the GPSO plan through the
``fetch`` the plane hands the autoscaler) apart from the engine's
``syncs`` (a training balancer counts its own: ``RLBalancer.fetches``).

``state_dict`` / ``load_state_dict`` snapshot every piece of mutable
decision state (forecast window, residual tracker, fractions, tick counter,
scaler internals including its random key), so a fresh plane that loads it
continues the exact decision stream.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Optional

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core import balancer as bal
from repro_torch.core.autoscaler import (GPSOAutoscaler, HPAAutoscaler,
                                         RBASAutoscaler, StaticAllocator)
from repro_torch.core.forecaster import forecast as nn_forecast
from repro_torch.core.forecaster import last_value_baseline
from repro_torch.device import host_to_device, resolve_device

# (balancer, autoscaler) pairs for the paper's §4.2 comparison matrix.
METHOD_SPECS = {
    "RRA": ("rr", "static"),
    "LCA": ("lc", "static"),
    "HPA": ("rr", "hpa"),
    "RBAS": ("rr", "rbas"),
    "OURS": ("rl", "gpso"),
    # extra references beyond the paper's table + ablations
    "WRR": ("wrr", "static"),
    "OURS-GA": ("rl", "ga"),     # GA-only autoscaler (no PSO refinement)
    "OURS-RR": ("rr", "gpso"),   # GPSO scaling but round-robin balancing
}


def make_autoscaler(kind: str, cfg, unit_cap: float, seed=0,
                    device="cuda"):
    if kind == "gpso":
        return GPSOAutoscaler(cfg, unit_cap, seed, device=device)
    if kind == "ga":
        return GPSOAutoscaler(cfg, unit_cap, seed, optimizer="ga",
                              device=device)
    if kind == "hpa":
        return HPAAutoscaler(cfg)
    if kind == "rbas":
        return RBASAutoscaler(cfg)
    if kind == "static":
        return StaticAllocator(max(1, cfg.max_replicas_per_node // 2))
    if kind == "none":
        return None
    raise ValueError(kind)


class ControlPlane:
    """Composes forecaster + balancer + autoscaler over a ClusterBackend."""

    def __init__(self, cfg, backend, *, balancer: str = "rr",
                 scaler: str = "static", unit_capacity: float = 1.0,
                 rl: Optional[bal.RLBalancer] = None,
                 forecaster_params=None, forecast_scale: float = 1.0,
                 train_rl: bool = False, explore: bool = False,
                 train_every: int = 2, seed: int = 0,
                 init_arrival: float = 1.0, device="cuda"):
        if balancer == "rl" and rl is None:
            raise ValueError("balancer='rl' needs an RLBalancer instance")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.backend = backend
        self.balancer = balancer
        self.rl = rl
        self.forecaster_params = forecaster_params
        self.forecast_scale = float(forecast_scale)
        self.train_rl = train_rl
        self.explore = explore
        self.train_every = train_every
        self.unit_capacity = unit_capacity
        self.scaler_kind = scaler
        self.scaler = make_autoscaler(scaler, cfg, unit_capacity, seed,
                                      device=self.device)
        n = backend.num_nodes
        self.t = 0
        self.window = np.full((cfg.forecast_window,), float(init_arrival),
                              np.float32)
        self.fractions = np.full((n,), 1.0 / n, np.float32)
        self._prev = None            # (obs, action, reward) of the last tick
        self._resid = np.zeros(64, np.float32)   # rolling forecast residuals
        self._prev_fc1 = None
        self.host_s = {"forecast": 0.0, "balance": 0.0, "learn": 0.0,
                       "scale": 0.0}
        self.fetches = 0
        self.fetch_wait = 0.0
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(device=self.device)
            # parameters made on the default stream are ready for this one
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    # -------------------------------------------------- checkpoint/restore
    def state_dict(self) -> dict:
        """Deep-copied snapshot of every piece of mutable decision state —
        loading it into a FRESH plane over the same backend continues the
        exact decision stream. The RL replay tuple is transient (one tick of
        context) and resets on restore; the rl balancer itself is
        externally owned."""
        return {
            "t": int(self.t),
            "window": self.window.copy(),
            "fractions": self.fractions.copy(),
            "resid": self._resid.copy(),
            "prev_fc1": self._prev_fc1,
            "scaler": copy.deepcopy(self.scaler),
        }

    def load_state_dict(self, state: dict) -> None:
        self.t = int(state["t"])
        self.window = state["window"].copy()
        self.fractions = state["fractions"].copy()
        self._resid = state["resid"].copy()
        self._prev_fc1 = state["prev_fc1"]
        self.scaler = copy.deepcopy(state["scaler"])
        self._prev = None

    # -------------------------------------------------------------- device
    def _on_plane(self):
        """Run the enclosed device work on the plane's own stream."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """Blocking fetch of a plane result (waits for the plane's stream
        only), counted apart from the engine's syncs."""
        with telemetry.span("plane.fetch", into=(self, "fetch_wait")):
            out = t.cpu().numpy()
        self.fetches += 1
        return out

    # ------------------------------------------------------------ forecast
    def _forecast(self, arrival_rate: float) -> np.ndarray:
        window = self.window[:, None] / self.forecast_scale
        if self.forecaster_params is not None:
            with self._on_plane():
                fc = self._fetch(nn_forecast(
                    self.forecaster_params,
                    host_to_device(window, self.device)))[:, 0]
        else:
            fc = last_value_baseline(torch.from_numpy(window),
                                     self.cfg.horizon).numpy()[:, 0]
        fc = fc.astype(np.float32)
        # rolling 1-step forecast-error tracker -> volatility-aware headroom
        if self._prev_fc1 is not None:
            self._resid = np.roll(self._resid, -1)
            self._resid[-1] = (arrival_rate / self.forecast_scale
                               - self._prev_fc1)
        self._prev_fc1 = float(fc[0])
        return fc

    # ------------------------------------------------------------- balance
    def _balance(self, obs, up, arrival_rate: float) -> np.ndarray:
        b = self.backend
        dev = self.device
        with self._on_plane():
            obs_t = host_to_device(obs, dev)
            up_t = host_to_device(up, dev)
            if self.balancer == "rr":
                fr = bal.round_robin(obs_t, up_t)
            elif self.balancer == "lc":
                fr = bal.least_connections(
                    host_to_device(b.queue_depths(), dev), up_t,
                    host_to_device(np.float32(
                        arrival_rate * self.cfg.tick_seconds), dev))
            elif self.balancer == "wrr":
                fr = bal.weighted_capacity(obs_t, up_t,
                                           host_to_device(b.capacity(), dev))
            elif self.balancer == "rl":
                fr = self.rl.act(obs_t, up_t, explore=self.explore)
            else:
                raise ValueError(self.balancer)
            return self._fetch(fr)

    # --------------------------------------------------------------- scale
    def _scale(self, m: dict, fc: np.ndarray, arrival_rate: float):
        cfg = self.cfg
        in_flight = self.backend.in_flight()
        if self.scaler_kind in ("gpso", "ga"):
            # measured service rates: once the backend's finished-request EMA
            # is warm (``service_rate`` per live replica), the planner uses
            # it instead of the static unit_capacity guess
            measured = m.get("service_rate")
            if measured:
                self.scaler.unit_capacity = float(measured)
            if self.t % cfg.scale_interval == 0 and self.t > 0:
                # provision for the P95 of predicted demand: forecast peak
                # plus 2 sigma of recent forecast error
                n = self.backend.num_nodes
                sigma = float(self._resid.std()) * self.forecast_scale
                peak = max(float(fc.max()) * self.forecast_scale,
                           float(arrival_rate)) + 2.0 * sigma
                node_demand = peak * np.maximum(self.fractions,
                                                1.0 / (4 * n))
                with self._on_plane(), telemetry.span("plane.gpso_plan"):
                    target = self.scaler.plan(
                        node_demand, self.t, in_flight,
                        node_speed=self.backend.node_speed,
                        slo_pressure=m.get("tier_pressure"),
                        preempt_risk=m.get("preempt_risk"),
                        fetch=self._fetch)
                with telemetry.span("frontend.scale_to"):
                    self.backend.scale_to(target)
            else:
                # emergency path: instantaneous overload on a node triggers
                # an immediate scale-up without waiting for the plan interval
                hot = m["utilization"] > 0.95
                if hot.any():
                    target = in_flight + hot.astype(np.int32)
                    with telemetry.span("frontend.scale_to"):
                        self.backend.scale_to(
                            np.minimum(target, cfg.max_replicas_per_node))
        elif self.scaler is not None and self.scaler_kind != "static":
            # rule-based scalers observe every tick (the k8s control loop)
            target = self.scaler.plan(m["utilization"], self.t, in_flight)
            with telemetry.span("frontend.scale_to"):
                self.backend.scale_to(target)
        # "static"/"none": the backend keeps its initial replica profile

    # ---------------------------------------------------------------- tick
    @telemetry.spanned("plane.step")
    def step(self, arrival_rate: float) -> dict:
        """One forecast -> balance -> advance -> (learn) -> scale tick."""
        cfg, host = self.cfg, self.host_s
        with telemetry.span("plane.forecast", into=(host, "forecast")):
            fc = self._forecast(arrival_rate)
            with telemetry.span("frontend.observe"):
                obs = self.backend.observe(fc)
                up = self.backend.up_mask()
        with telemetry.span("plane.balance", into=(host, "balance")):
            self.fractions = self._balance(obs, up, arrival_rate)
            with telemetry.span("frontend.route"):
                self.backend.route(self.fractions)
        m = self.backend.tick(arrival_rate)

        with telemetry.span("plane.learn", into=(host, "learn")):
            if self.balancer == "rl":
                # Eq.5, tier-weighted (untiered backends omit tier_slo_cost)
                reward = bal.reward_fn(
                    m["response_time"], m["mean_utilization"], cfg.alpha,
                    cfg.beta, m["overload"], slo_cost=cfg.slo_gamma *
                    float(m.get("tier_slo_cost") or 0.0))
                if self._prev is not None and self.train_rl:
                    self.rl.observe(self._prev[0], self._prev[1],
                                    float(self._prev[2]), obs, up)
                    if self.t % self.train_every == 0:
                        with self._on_plane():
                            self.rl.train_step()
                self._prev = (obs, self.fractions, reward)

        with telemetry.span("plane.scale", into=(host, "scale")):
            self._scale(m, fc, arrival_rate)
            self.window = np.roll(self.window, -1)
            self.window[-1] = arrival_rate
            self.t += 1
        return m

    def run(self, arrivals: np.ndarray) -> list:
        """Drive a whole trace; returns the per-tick metrics dicts."""
        return [self.step(float(a)) for a in arrivals]
