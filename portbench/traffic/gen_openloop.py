"""Open-loop arrivals in wall time, for every traffic file of kind
``openloop``.

A traffic file gives a mean rate (requests/s), a rate schedule and the
length distributions of prompts and outputs. ``generate`` turns them into
one list of arrivals over named blocks of the run's clock (the warm-up,
the measured window, the tail after it): each arrival has its due time,
its prompt ids and its ``max_new_tokens``.

Every seed gets the same work in another order. Within each block the
arrivals of each stretch of constant rate have a fixed count (rate x
length, rounded) and a fixed set of gaps, the exponential distribution's
quantiles at evenly spaced levels, which the seed permutes and which are
scaled to fill the stretch exactly; the prompt and output lengths of a
block are the quantiles of their distributions at evenly spaced levels,
permuted by the seed. So two seeds differ in which request comes when and
in the token ids, not in how many requests, tokens or gaps there are.

Schedules:

* ``{"kind": "constant"}``: the mean rate throughout (Poisson-like gaps);
* ``{"kind": "onoff", "cycle_s": C, "on_s": A, "on_factor": F_on,
  "off_factor": F_off}``: a cycle of C seconds whose first A seconds run
  at F_on x the mean rate and the rest at F_off x, with phase 0 at the
  start of the measured window (BurstGPT-like bursts; pick the factors so
  that A F_on + (C - A) F_off = C and the mean is the mean rate).

Length distributions: ``{"dist": "lognormal", "median": m, "sigma": s,
"min": lo, "max": hi}`` (clipped) or ``{"dist": "uniform", "min": lo,
"max": hi}`` (whole numbers, both ends included).
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np


@dataclasses.dataclass
class Arrival:
    due: float            # seconds on the run's clock
    prompt: list          # token ids
    max_new_tokens: int
    block: str            # the block it is due in


def _rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, *salt])


def rate_at(schedule: dict, rate: float, t: float, anchor: float) -> float:
    """The schedule's rate (requests/s) at clock ``t``, cycles anchored at
    ``anchor``."""
    kind = schedule.get("kind", "constant")
    if kind == "constant":
        return rate
    if kind == "onoff":
        phase = (t - anchor) % schedule["cycle_s"]
        on = phase < schedule["on_s"]
        return rate * (schedule["on_factor"] if on else schedule["off_factor"])
    raise ValueError(f"unknown schedule kind {kind!r}")


def segments(schedule: dict, rate: float, lo: float, hi: float,
             anchor: float) -> list:
    """[(start, end, rate)] stretches of constant rate covering [lo, hi)."""
    cuts = {lo, hi}
    if schedule.get("kind", "constant") == "onoff":
        c, a = schedule["cycle_s"], schedule["on_s"]
        k = math.floor((lo - anchor) / c)
        while anchor + k * c < hi:
            for edge in (anchor + k * c, anchor + k * c + a):
                if lo < edge < hi:
                    cuts.add(edge)
            k += 1
    edges = sorted(cuts)
    return [(a, b, rate_at(schedule, rate, a, anchor))
            for a, b in zip(edges, edges[1:])]


def quantiles(dist: dict, n: int) -> np.ndarray:
    """``n`` lengths at the levels (i + 0.5) / n of ``dist``, whole
    numbers, in increasing order."""
    u = (np.arange(n) + 0.5) / max(n, 1)
    if dist["dist"] == "lognormal":
        z = np.asarray([NormalDist().inv_cdf(x) for x in u])
        v = np.exp(math.log(dist["median"]) + dist["sigma"] * z)
        return np.clip(np.rint(v), dist["min"], dist["max"]).astype(np.int64)
    if dist["dist"] == "uniform":
        span = dist["max"] - dist["min"] + 1
        return (dist["min"] + np.floor(u * span)).astype(np.int64)
    raise ValueError(f"unknown length distribution {dist['dist']!r}")


def mean_length(dist: dict, n: int = 4096) -> float:
    return float(quantiles(dist, n).mean())


def _due_times(seg_lo: float, seg_hi: float, n: int,
               rng: np.random.Generator) -> np.ndarray:
    """``n`` due times inside [seg_lo, seg_hi): the n + 1 exponential
    quantile gaps, permuted, scaled to the stretch, summed."""
    u = (np.arange(n + 1) + 0.5) / (n + 1)
    gaps = rng.permutation(-np.log1p(-u))
    gaps *= (seg_hi - seg_lo) / gaps.sum()
    return seg_lo + np.cumsum(gaps)[:n]


def generate(traffic: dict, seed: int, blocks: list, vocab: int,
             rate: float | None = None, anchor: float = 0.0) -> list:
    """The arrivals of ``traffic`` over ``blocks`` [(name, start, end)],
    in due order. ``rate`` replaces the file's mean rate (a sweep);
    ``anchor`` is the clock at which an on/off cycle starts. Token ids are
    drawn from 1 .. vocab - 1."""
    rate = traffic["rate"] if rate is None else rate
    sched = traffic.get("schedule", {"kind": "constant"})
    out = []
    for bi, (name, lo, hi) in enumerate(blocks):
        dues = []
        for si, (a, b, r) in enumerate(segments(sched, rate, lo, hi,
                                                anchor)):
            n = int(round(r * (b - a)))
            dues.append(_due_times(a, b, n, _rng(seed, 1, bi, si)))
        dues = np.sort(np.concatenate(dues)) if dues else np.zeros(0)
        n = len(dues)
        rng = _rng(seed, 2, bi)
        plens = rng.permutation(quantiles(traffic["prompt"], n))
        olens = rng.permutation(quantiles(traffic["output"], n))
        ids = _rng(seed, 3, bi)
        for t, p, o in zip(dues, plens, olens):
            out.append(Arrival(float(t), ids.integers(1, vocab, int(p))
                               .tolist(), int(o), name))
    return out
