"""The metric arithmetic of the end-to-end metrics, kept apart from the
run so that tests can hold it to hand counts."""
from __future__ import annotations

import math


def nearest_rank(values, q: float) -> float:
    """The ``q``-th percentile (0 < q <= 100) by nearest rank: the
    smallest value with at least q% of the values at or below it. A
    request that was never served enters as +inf and stays in the
    count."""
    xs = sorted(values)
    if not xs:
        return math.inf
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[k - 1]


def ttfts(due: dict, first: dict) -> list:
    """Seconds from each counted request's due time to its first token,
    +inf where it never came. ``due``: rid -> due clock; ``first``: rid
    -> clock of the first token (missing: never)."""
    return [first[r] - t if r in first else math.inf for r, t in due.items()]


def gaps_in(stamps: list, lo: float, hi: float) -> list:
    """The gaps between consecutive tokens of one request whose later
    token came in [lo, hi)."""
    return [b - a for a, b in zip(stamps, stamps[1:]) if lo <= b < hi]


def tokens_in(stamps: list, lo: float, hi: float) -> int:
    return sum(1 for s in stamps if lo <= s < hi)


def backlog_trend(series: list) -> dict:
    """A window's backlog [(seconds into the window, requests waiting)]:
    its first and last readings and its least-squares slope in requests
    a second (the sweep's test of whether a rate is sustained)."""
    if len(series) < 2:
        return {"start": None, "end": None, "slope_per_s": None}
    ts = [t for t, _ in series]
    ys = [y for _, y in series]
    mt, my = sum(ts) / len(ts), sum(ys) / len(ys)
    var = sum((t - mt) ** 2 for t in ts)
    slope = sum((t - mt) * (y - my) for t, y in series) / var if var else 0.0
    return {"start": ys[0], "end": ys[-1], "max": max(ys),
            "slope_per_s": slope}
