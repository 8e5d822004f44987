"""Closed-loop client population (the Locust idiom) for the elastic
frontend (a copy of ``repro.workload.clients``; numpy only).

Open-loop traces (``workload.trace``) push an arrival *rate* regardless of
what the cluster does — fine for steady-state capacity planning, wrong for
overload: real clients wait for their answer (closed loop), time out, come
back with retries, and eventually give up. Under saturation that feedback
*amplifies* load (the retry storm) exactly when capacity is scarcest, which
is the regime where goodput — not raw tok/s — separates a robust autoscaler
from a fragile one.

``ClientPool`` models N users against one ``ElasticClusterFrontend``:

  * **think time** — after a success, a client waits ``Exp(think_time)``
    ticks before issuing its next request;
  * **timeout → retry** — each attempt carries ``deadline_tick = now +
    timeout`` (per-tier scalar or dict), so the *server* retires it inside
    the normal fleet retire rule; the client watches the frontend's
    ``RequestLedger`` and, on ``timed_out``/``rejected``, retries the SAME
    rid with a FRESH ``Request`` after capped exponential backoff with
    jitter, up to ``max_retries``;
  * **abandonment** — a client out of retry budget abandons the rid
    (``frontend.abandon``) and returns to thinking; a late completion for
    an abandoned rid is wasted work, not goodput;
  * **spawn-rate ramp** — ``spawn_rate`` activates users per tick (the
    flash-crowd shape: 1000 users arriving at 50/tick), default everyone
    at once.

Exactly-once accounting is the frontend's job (ledger suppression of a
retry racing its original completion); the pool's job is only to generate
the closed-loop pressure and tally the client-side view (per-tier issued /
ok / timed-out / retries / abandons and end-to-end response times of
successes). Drive it as ``pool.tick()`` immediately before each
``frontend.tick`` (or ``ControlPlane.step``); submissions land in
``pending`` and route on that same tick, exactly like open-loop arrivals.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np

# NOTE: no ``repro_torch.serving`` import here — ``serving.engine`` imports
# ``workload.trace``, so importing it back from the workload package would
# be circular. The pool only *consumes* ``Request`` objects produced by the
# caller's ``request_factory``.

_THINKING, _WAITING, _BACKOFF = 0, 1, 2


class _Client:
    __slots__ = ("state", "timer", "rid", "attempt", "sent_at", "tier")

    def __init__(self, timer: float):
        self.state = _THINKING
        self.timer = timer          # ticks left in thinking/backoff
        self.rid = -1               # rid of the in-flight / retried request
        self.attempt = 0            # attempts already issued for this rid
        self.sent_at = 0.0          # first-attempt issue tick (E2E latency)
        self.tier = "standard"


class ClientPool:
    """N closed-loop users driving a frontend (see module docstring)."""

    def __init__(self, frontend, num_clients: int, *,
                 request_factory: Callable[[int, int], Request],
                 think_time: float = 2.0,
                 timeout: Union[float, dict] = 8.0,
                 max_retries: int = 3,
                 backoff_base: float = 1.0, backoff_cap: float = 8.0,
                 spawn_rate: Optional[float] = None, seed: int = 0):
        self.fe = frontend
        self.request_factory = request_factory
        self.think_time = float(think_time)
        self.timeout = timeout
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.spawn_rate = spawn_rate      # clients activated per tick
        self.rng = np.random.default_rng(seed)
        self._dormant = int(num_clients)  # not yet ramped in
        self._spawn_acc = 0.0
        self.clients: list = []
        self.quiesced = False             # stop issuing new work (wind-down)
        self.stats = self._zero_row()
        self.tier_stats: dict = {}
        self.latencies: list = []         # (tier, e2e ticks) of successes

    @staticmethod
    def _zero_row() -> dict:
        return {"issued": 0, "ok": 0, "timed_out": 0, "retries": 0,
                "abandoned": 0, "rejected": 0, "shed": 0}

    def _row(self, tier: str) -> dict:
        return self.tier_stats.setdefault(tier, self._zero_row())

    def _bump(self, tier: str, key: str, n: int = 1):
        self.stats[key] += n
        self._row(tier)[key] += n

    def _tier_timeout(self, tier: str) -> float:
        if isinstance(self.timeout, dict):
            return float(self.timeout.get(tier, self.timeout.get(
                "default", 8.0)))
        return float(self.timeout)

    def _think(self) -> float:
        return float(self.rng.exponential(self.think_time)) \
            if self.think_time > 0 else 0.0

    def _backoff(self, attempt: int) -> float:
        # capped exponential with full jitter: retries decorrelate instead
        # of re-synchronizing into a thundering herd
        cap = min(self.backoff_cap, self.backoff_base * (2.0 ** (attempt - 1)))
        return float(self.rng.uniform(0.0, max(cap, 1e-9)))

    @property
    def active_clients(self) -> int:
        return len(self.clients)

    @property
    def outstanding(self) -> int:
        return sum(1 for c in self.clients if c.state == _WAITING)

    def quiesce(self):
        """Stop issuing new requests (wind-down: in-flight attempts keep
        running and are harvested by later ``tick``s / ``finalize``)."""
        self.quiesced = True

    # ------------------------------------------------------------- ticking
    def _spawn_wave(self):
        if self._dormant <= 0:
            return
        if self.spawn_rate is None:
            n = self._dormant
        else:
            self._spawn_acc += float(self.spawn_rate)
            n = min(self._dormant, int(self._spawn_acc))
            self._spawn_acc -= n
        self._dormant -= n
        for _ in range(n):
            self.clients.append(_Client(self._think()))

    def _issue(self, c: _Client, now: int, retry: bool):
        if retry:
            c.attempt += 1
            self._bump(c.tier, "retries")
        else:
            c.rid = self.fe.alloc_rid()
            c.attempt = 1
            c.sent_at = float(now)
        # every attempt is a FRESH Request object (a served-on object must
        # never re-enter the queues) with a fresh deadline
        req = self.request_factory(c.rid, now)
        c.tier = req.tier
        req.deadline_tick = float(now) + self._tier_timeout(req.tier)
        self._bump(c.tier, "issued")
        accepted = self.fe.submit(req)
        if accepted:
            c.state = _WAITING
            return
        # admission said no — the cap ('rejected') or overload shedding
        # ('shed', multi-cell router): backoff-retry like a timeout,
        # abandon when out of budget
        st = self.fe.ledger.state.get(c.rid)
        self._bump(c.tier, "shed" if st == "shed" else "rejected")
        self._settle_failure(c)

    def _settle_failure(self, c: _Client):
        if c.attempt >= self.max_retries + 1 or self.quiesced:
            self.fe.abandon(c.rid)
            self._bump(c.tier, "abandoned")
            c.state = _THINKING
            c.timer = self._think()
        else:
            c.state = _BACKOFF
            c.timer = self._backoff(c.attempt)

    def tick(self):
        """One closed-loop round: harvest terminal rids from the ledger,
        ramp new users in, count down think/backoff timers and (re)issue
        requests. Call immediately before ``frontend.tick``."""
        now = int(self.fe.t)
        states = self.fe.ledger.state
        for c in self.clients:
            if c.state != _WAITING:
                continue
            st = states.get(c.rid)
            if st == "finished":
                self._bump(c.tier, "ok")
                self.latencies.append((c.tier, float(now) - c.sent_at))
                c.state = _THINKING
                c.timer = self._think()
            elif st in ("timed_out", "rejected", "shed"):
                if st == "timed_out":
                    self._bump(c.tier, "timed_out")
                elif st == "shed":
                    # queued at submit time, shed later by the router's
                    # admission sweep (pressure crossed the threshold)
                    self._bump(c.tier, "shed")
                self._settle_failure(c)
        self._spawn_wave()
        if self.quiesced:
            return
        for c in self.clients:
            if c.state == _WAITING:
                continue
            c.timer -= 1.0
            if c.timer > 0:
                continue
            self._issue(c, now, retry=(c.state == _BACKOFF))

    def finalize(self):
        """Post-drain harvest: classify whatever was still in flight when
        the driver stopped ticking (every attempt has completed by now —
        ``run_until_drained`` guarantees it)."""
        self.quiesce()
        states = self.fe.ledger.state
        for c in self.clients:
            if c.state == _BACKOFF:
                # a retry that will never be issued: abandon the rid so it
                # leaves its (terminal but retryable) state for good
                self.fe.abandon(c.rid)
                self._bump(c.tier, "abandoned")
            elif c.state == _WAITING:
                st = states.get(c.rid)
                if st == "finished":
                    self._bump(c.tier, "ok")
                    self.latencies.append(
                        (c.tier, float(self.fe.t) - c.sent_at))
                else:
                    if st == "timed_out":
                        self._bump(c.tier, "timed_out")
                    elif st == "shed":
                        self._bump(c.tier, "shed")
                    self.fe.abandon(c.rid)
                    self._bump(c.tier, "abandoned")
            else:
                continue
            c.state = _THINKING
            c.timer = self._think()

    # ------------------------------------------------------------- reports
    def summary(self) -> dict:
        """Client-side aggregate + per-tier rows (counts are attempts for
        ``issued``/``retries``, rids for ``ok``/``abandoned``)."""
        lat = [t for _, t in self.latencies]
        return {
            "clients": self.active_clients + self._dormant,
            "latency_mean": float(np.mean(lat)) if lat else None,
            "latency_p95": float(np.percentile(lat, 95)) if lat else None,
            **self.stats,
            "per_tier": {k: dict(v) for k, v in self.tier_stats.items()},
        }
