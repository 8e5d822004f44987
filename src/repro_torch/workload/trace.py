"""SLO tiers, the synthetic arrival trace and the forecaster's training
windows (copies of ``repro.workload.trace``'s ``TierSet``/``parse_tiers``,
``TraceConfig``/``generate_trace``, ``LOAD_LEVELS`` and
``make_forecast_dataset``; numpy only).

Real inference fleets serve several QoS classes over one pool
(interactive premium traffic, default standard traffic, throughput-oriented
batch jobs). ``TierSpec``/``TierSet`` describe that mix: each tier has a
traffic ``share`` (workload sampling), a scheduling ``weight`` (the
weighted-deficit admission quantum in the serving engine -- higher weight
admits first, lower weight keeps a bounded fraction so it never starves)
and optional TTFT/TBT targets in ticks. ``parse_tiers`` reads the
``premium:0.2:w5,standard:0.5:w2,batch:0.3:w1`` CLI syntax (an optional 4th
``:T`` field is the TTFT target). The default is a single ``standard`` tier,
which makes every tier-aware code path identical to the untiered scheduler.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One QoS class: traffic share, admission weight, latency targets."""
    name: str
    share: float = 1.0              # fraction of generated traffic
    weight: float = 1.0             # weighted-deficit admission quantum
    ttft_target: float = math.inf   # ticks; inf = no TTFT SLO
    tbt_target: float = math.inf    # ticks/token; inf = no TBT SLO


class TierSet:
    """Ordered collection of ``TierSpec``s with the derived views every
    layer needs: priority order (weight-descending, declaration-stable),
    name lookup with a safe fallback, share sampling for workload
    generators, and the tier-weighted aggregates (queue pressure, SLO
    violation cost) the planner and the Eq.5 reward consume."""

    def __init__(self, specs):
        specs = list(specs)
        if not specs:
            raise ValueError("TierSet needs at least one tier")
        self.specs = specs
        self.names = [s.name for s in specs]
        self._by_name = {s.name: i for i, s in enumerate(specs)}
        self.weights = np.asarray([s.weight for s in specs], np.float64)
        shares = np.asarray([max(s.share, 0.0) for s in specs], np.float64)
        self.shares = shares / max(shares.sum(), 1e-12)
        # priority: higher weight first; ties keep declaration order
        self.priority = sorted(range(len(specs)),
                               key=lambda i: (-specs[i].weight, i))
        self._rank = {t: r for r, t in enumerate(self.priority)}
        # unknown tier names map to the lowest-priority tier (conservative)
        self._fallback = self.priority[-1]

    def __len__(self) -> int:
        return len(self.specs)

    def __iter__(self):
        return iter(self.specs)

    def index(self, name: str) -> int:
        return self._by_name.get(name, self._fallback)

    def rank(self, name: str) -> int:
        """Priority rank of a tier name: 0 = highest priority."""
        return self._rank[self.index(name)]

    def sample(self, rng: np.random.Generator) -> str:
        """Draw a tier name by traffic share (workload stamping)."""
        return self.names[int(rng.choice(len(self.specs), p=self.shares))]

    # ------------------------------------------------- weighted aggregates
    def pressure(self, tier_queues: np.ndarray) -> np.ndarray:
        """Tier-weighted backlog per node: (T, N) queue depths -> (N,).

        Weights are normalized by their mean so a single-tier set reduces to
        the plain queue depth — the signal the GPSO planner's SLO cost term
        consumes (premium backlog weighs more than batch backlog)."""
        q = np.asarray(tier_queues, np.float64)
        w = self.weights / max(self.weights.mean(), 1e-12)
        return (w[:, None] * q).sum(axis=0).astype(np.float32)

    def slo_cost(self, violations) -> float:
        """Weighted mean SLO violation in [0, 1]: per-tier violation levels
        (dict name -> level or (T,) array) -> one Eq.5 penalty scalar."""
        if isinstance(violations, dict):
            v = np.asarray([violations.get(n, 0.0) for n in self.names],
                           np.float64)
        else:
            v = np.asarray(violations, np.float64)
        v = np.where(np.isfinite(v), v, 0.0)
        return float((self.weights * v).sum() / max(self.weights.sum(),
                                                    1e-12))


DEFAULT_TIERS = TierSet([TierSpec("standard")])


def parse_tiers(spec: str) -> TierSet:
    """Parse ``name:share:wW[:ttft]`` comma lists, e.g.
    ``premium:0.2:w5:4,standard:0.5:w2,batch:0.3:w1``. Empty string ->
    the single-tier default."""
    spec = (spec or "").strip()
    if not spec:
        return DEFAULT_TIERS
    tiers = []
    for part in spec.split(","):
        fields = part.strip().split(":")
        if not fields[0]:
            raise ValueError(f"bad tier spec {part!r}")
        name = fields[0]
        share = float(fields[1]) if len(fields) > 1 else 1.0
        weight = 1.0
        if len(fields) > 2:
            w = fields[2]
            weight = float(w[1:] if w.startswith("w") else w)
        ttft = float(fields[3]) if len(fields) > 3 else math.inf
        if share < 0 or weight <= 0 or ttft <= 0:
            raise ValueError(f"bad tier spec {part!r}")
        tiers.append(TierSpec(name, share=share, weight=weight,
                              ttft_target=ttft))
    return TierSet(tiers)


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    ticks: int = 2000
    base_rate: float = 400.0        # requests/sec at the diurnal mean
    diurnal_period: int = 600       # ticks per "day"
    diurnal_amp: float = 0.45       # relative amplitude
    ar_rho: float = 0.9             # AR(1) coefficient
    ar_sigma: float = 0.05          # AR(1) innovation (relative)
    burst_rate: float = 1 / 300.0   # bursts per tick (exp inter-arrival)
    burst_pareto_alpha: float = 1.5
    burst_scale: float = 0.8        # burst magnitude (x base rate)
    burst_decay: float = 0.92       # per-tick burst decay
    dip_rate: float = 1 / 900.0
    dip_depth: float = 0.5
    dip_len: int = 40
    cost_lognorm_sigma: float = 0.6  # per-request cost multiplier spread


def generate_trace(cfg: TraceConfig = TraceConfig(), seed: int = 0,
                   load_scale: float = 1.0) -> dict:
    """Returns {"arrivals": (T,) req/s, "cost_mult": (T,) mean cost mult}."""
    rng = np.random.default_rng(seed)
    T = cfg.ticks
    t = np.arange(T)
    diurnal = 1.0 + cfg.diurnal_amp * np.sin(2 * np.pi * t / cfg.diurnal_period
                                             - np.pi / 2)
    # AR(1) noise
    ar = np.zeros(T)
    innov = rng.normal(0, cfg.ar_sigma, T)
    for i in range(1, T):
        ar[i] = cfg.ar_rho * ar[i - 1] + innov[i]
    # bursts
    burst = np.zeros(T)
    level = 0.0
    for i in range(T):
        if rng.random() < cfg.burst_rate:
            level += (rng.pareto(cfg.burst_pareto_alpha) + 1) * cfg.burst_scale
        burst[i] = level
        level *= cfg.burst_decay
    # dips
    dip = np.ones(T)
    i = 0
    while i < T:
        if rng.random() < cfg.dip_rate:
            dip[i:i + cfg.dip_len] *= cfg.dip_depth
            i += cfg.dip_len
        i += 1
    arrivals = cfg.base_rate * load_scale * np.maximum(
        diurnal * (1 + ar) * dip + burst, 0.02)
    cost = np.exp(rng.normal(0, cfg.cost_lognorm_sigma, T)
                  - cfg.cost_lognorm_sigma ** 2 / 2)
    return {"arrivals": arrivals.astype(np.float32),
            "cost_mult": cost.astype(np.float32)}


LOAD_LEVELS = {"low": 0.5, "medium": 1.0, "high": 1.8, "ultra": 2.8}


def make_forecast_dataset(arrivals: np.ndarray, window: int, horizon: int):
    """Sliding windows for forecaster training: (M, W, 1), (M, T, 1)."""
    T = arrivals.shape[0]
    xs, ys = [], []
    scale = arrivals.mean()
    a = arrivals / scale
    for i in range(T - window - horizon):
        xs.append(a[i:i + window, None])
        ys.append(a[i + window:i + window + horizon, None])
    return np.stack(xs), np.stack(ys), scale
