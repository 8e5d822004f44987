"""Experiment runner: (balancer × autoscaler) over a workload trace (the
port of ``repro.sim.experiment`` and of ``examples/autoscale_sim.py``).

Reproduces the paper's comparison matrix (§4.2):

    RRA   — round robin, static replicas
    LCA   — least connections, static replicas
    HPA   — round robin + Kubernetes HPA autoscaling
    RBAS  — round robin + rule-based autoscaling
    OURS  — MADRL (GCN+DDPG) balancer + GRU forecast + GPSO autoscaler

and produces the Fig.1/2/3 metrics (resource utilization, response time,
scaling efficiency) plus fairness/SLO/cost aggregates. The per-tick loop is
``repro_torch.control.ControlPlane`` over the fluid ``ClusterSim``;
everything that runs on a device (the sim's tick, the balancers, the GRU,
the DDPG updates, GPSO) runs on ``device``.

    python -m repro_torch.sim.experiment [--ticks 400] [--load 1.8] \\
        [--device cuda]

trains the GRU forecaster and the MADRL balancer, then runs one episode of
each method and prints the reference's table.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.configs.paper_cluster import ClusterConfig
from repro_torch.control.backend import SimBackend
from repro_torch.control.plane import METHOD_SPECS, ControlPlane  # noqa: F401
from repro_torch.core import balancer as bal
from repro_torch.core.forecaster import train_forecaster
from repro_torch.core.gpso import TorchKey
from repro_torch.sim.cluster import ClusterSim
from repro_torch.workload.trace import (TraceConfig, generate_trace,
                                        make_forecast_dataset)

METHODS = ("RRA", "LCA", "HPA", "RBAS", "OURS")


@dataclasses.dataclass
class EpisodeResult:
    name: str
    utilization: np.ndarray       # (T,) mean healthy-node utilization
    response_time: np.ndarray     # (T,)
    fairness: np.ndarray          # (T,) Jain index over node utilizations
    served: float
    replica_ticks: int
    unit_capacity: float
    cfg: ClusterConfig
    tick_s: Optional[np.ndarray] = None   # (T,) host seconds of each tick

    # ---------------------------------------------------------- aggregates
    def summary(self, warmup: int = 50, slo: float = 2.0) -> dict:
        u = self.utilization[warmup:]
        r = self.response_time[warmup:]
        f = self.fairness[warmup:]
        cap_work = self.replica_ticks * self.unit_capacity * \
            self.cfg.tick_seconds
        return {
            "mean_util": float(np.mean(u)),
            "std_util": float(np.std(u)),
            "mean_resp": float(np.mean(r)),
            "p95_resp": float(np.percentile(r, 95)),
            "fairness": float(np.mean(f)),
            "slo_attainment": float(np.mean(r < slo)),
            "scaling_efficiency": float(self.served / max(cap_work, 1e-9)),
            "cost": float(self.replica_ticks),
        }


def jain_fairness(x: np.ndarray) -> float:
    s, s2 = x.sum(), (x ** 2).sum()
    n = x.shape[0]
    return float(s * s / max(n * s2, 1e-12))


def collect_episode(plane: ControlPlane, arrivals: np.ndarray, name: str,
                    cfg: ClusterConfig, unit_capacity: float) -> EpisodeResult:
    """Drive a ControlPlane over a trace and aggregate the figure metrics
    (and each tick's host seconds).

    Backend-agnostic: works for SimBackend and ElasticClusterFrontend alike
    (both emit the same metric keys)."""
    T = arrivals.shape[0]
    utils, resps, fairs = np.zeros(T), np.zeros(T), np.zeros(T)
    tick_s = np.zeros(T)
    served_total, replica_ticks = 0.0, 0
    for t in range(T):
        t0 = time.perf_counter()
        m = plane.step(float(arrivals[t]))
        tick_s[t] = time.perf_counter() - t0
        utils[t] = m["mean_utilization"]
        resps[t] = m["response_time"]
        fairs[t] = jain_fairness(m["utilization"] + 1e-6)
        served_total += m["served"]
        replica_ticks += m["replica_ticks"]
    return EpisodeResult(name, utils, resps, fairs, served_total,
                         replica_ticks, unit_capacity, cfg, tick_s)


def make_plane(cfg: ClusterConfig, trace: dict, method: str, *,
               unit_capacity: float, rl: Optional[bal.RLBalancer] = None,
               forecaster_params=None, forecast_scale: Optional[float] = None,
               train_rl: bool = False, explore: bool = False,
               failures: bool = True, seed: int = 0, train_every: int = 2,
               device="cuda") -> ControlPlane:
    """The plane ``run_episode`` drives: ``method``'s balancer and scaler
    over a fresh seeded ``ClusterSim`` on ``device``."""
    balancer_kind, scaler_kind = METHOD_SPECS[method]
    sim = ClusterSim(cfg, unit_capacity, seed=seed, failures=failures,
                     device=device)
    arrivals = trace["arrivals"]
    if forecast_scale is None:
        forecast_scale = float(arrivals.mean())
    return ControlPlane(
        cfg, SimBackend(sim), balancer=balancer_kind, scaler=scaler_kind,
        unit_capacity=unit_capacity, rl=rl,
        forecaster_params=forecaster_params, forecast_scale=forecast_scale,
        train_rl=train_rl, explore=explore, train_every=train_every,
        seed=seed, init_arrival=float(arrivals[:10].mean()), device=device)


def run_episode(cfg: ClusterConfig, trace: dict, method: str, *,
                unit_capacity: float, **kw) -> EpisodeResult:
    """One episode of ``method`` over ``trace``; ``kw`` as ``make_plane``."""
    plane = make_plane(cfg, trace, method, unit_capacity=unit_capacity, **kw)
    return collect_episode(plane, trace["arrivals"], method, cfg,
                           unit_capacity)


def train_rl_balancer(cfg: ClusterConfig, traces: list, *,
                      unit_capacity: float, forecaster_params=None,
                      forecast_scale: float = 1.0, episodes: int = 3,
                      seed: int = 0, device="cuda",
                      rl: Optional[bal.RLBalancer] = None) -> bal.RLBalancer:
    """Train the MADRL balancer across trace episodes (exploration on).
    ``rl`` is the balancer to train (default: a new one seeded with
    ``seed``)."""
    if rl is None:
        rl = bal.RLBalancer(cfg, 4 + cfg.horizon, seed=seed, device=device)
    for ep in range(episodes):
        trace = traces[ep % len(traces)]
        run_episode(cfg, trace, "OURS", unit_capacity=unit_capacity, rl=rl,
                    forecaster_params=forecaster_params,
                    forecast_scale=forecast_scale, train_rl=True,
                    explore=True, failures=False, seed=seed + ep,
                    device=device)
    return rl


def experiment(ticks: int = 400, load: float = 1.8, device="cuda",
               log=print) -> dict:
    """The paper's experiment in miniature, as the reference's
    ``examples/autoscale_sim.py``: train the GRU forecaster (300 steps on a
    1,200-tick trace) and the MADRL balancer (4 episodes over 3 traces of
    400 ticks), then one episode of each of ``METHODS`` (seed 1, unit
    capacity 30) on a ``ticks``-tick trace at ``load``. Returns the
    episodes and their summaries by method, the trained balancer and
    forecaster, the forecaster's losses and each stage's seconds."""
    cfg = ClusterConfig(num_nodes=8)
    trace = generate_trace(TraceConfig(ticks=ticks), seed=0, load_scale=load)
    secs = {}

    log("[sim] training demand forecaster (GRU)...")
    t0 = time.perf_counter()
    ftrace = generate_trace(TraceConfig(ticks=1200), seed=7, load_scale=load)
    X, Y, _ = make_forecast_dataset(ftrace["arrivals"], cfg.forecast_window,
                                    cfg.horizon)
    fp, losses = train_forecaster(TorchKey.from_seed(0, device), X, Y,
                                  cfg.forecast_hidden, steps=300,
                                  device=device)
    secs["forecaster"] = time.perf_counter() - t0
    log(f"[sim] forecaster mse {losses[0]:.3f} -> {losses[-1]:.3f}")

    log("[sim] training MADRL balancer (GCN+DDPG)...")
    t0 = time.perf_counter()
    rl = train_rl_balancer(
        cfg, [generate_trace(TraceConfig(ticks=400), seed=s, load_scale=load)
              for s in range(3)],
        unit_capacity=30.0, episodes=4, forecaster_params=fp, device=device)
    secs["balancer"] = time.perf_counter() - t0

    log(f"\n{'method':6s} {'util':>6s} {'resp(s)':>8s} {'p95':>8s} "
        f"{'SLO':>5s} {'fair':>6s} {'eff':>6s} {'cost':>7s}")
    t0 = time.perf_counter()
    results, summaries = {}, {}
    for meth in METHODS:
        kw = {"rl": rl, "forecaster_params": fp} if meth == "OURS" else {}
        results[meth] = run_episode(cfg, trace, meth, unit_capacity=30.0,
                                    seed=1, device=device, **kw)
        summaries[meth] = s = results[meth].summary()
        log(f"{meth:6s} {s['mean_util']:6.3f} {s['mean_resp']:8.3f} "
            f"{s['p95_resp']:8.3f} {s['slo_attainment']:5.2f} "
            f"{s['fairness']:6.3f} {s['scaling_efficiency']:6.3f} "
            f"{s['cost']:7.0f}")
    secs["episodes"] = time.perf_counter() - t0
    return {"results": results, "summaries": summaries, "rl": rl,
            "forecaster": fp, "losses": losses, "seconds": secs}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ticks", type=int, default=400)
    ap.add_argument("--load", type=float, default=1.8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    experiment(args.ticks, args.load, args.device)


if __name__ == "__main__":
    main()
