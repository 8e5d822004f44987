"""Request-level serving engine: continuous batching over real model forwards
(the port of the standalone half of ``repro.serving.engine``).

``ReplicaEngine`` runs one model replica: a slot-based KV pool on the
device, per-slot positions (the vector-``pos`` decode path),
admit-on-free-slot, greedy sampling, retire-on-EOS/max-tokens. Prompts are
right-padded to power-of-two length buckets and admitted in batched
prefill calls, so the prefill sees O(log max_seq * log max_batch) distinct
shapes in total (``prefill_traces`` counts them -- the analogue of the
reference's jit retrace count). Padded prefill is exact for the dense
family: causal attention masks trailing pads. Prompts longer than
``max_seq - 1`` are truncated to their last ``max_seq - 1`` tokens at
admission (the KV pool can never overflow).

**SLO tiers.** Each replica's pending queue is a ``TieredQueue``: one FIFO
per priority class (``workload.trace.TierSet``), drained in weighted-deficit
round-robin order. The default single tier is a plain FIFO.

``ClusterFrontend`` stitches several standalone replicas together behind a
balancer policy (``rr``, ``lc`` or ``fractions``): the reference's drain
mode with ``fleet_batch=False``. Each ``step`` admits and decodes every
replica once, with one blocking host sync per dispatch
(``syncs`` / ``sync_wait`` account for them).

Not yet ported: chunked prefill (``chunk_len > 0``), the int8 KV codec,
the fleet-batched slab (``FleetGroup``, ``fleet_batch=True``), the async
tick, the elastic frontend, and families other than dense. Asking for any
of them raises.

The device pool is updated in place: prefill writes a bucket-length cache
whose rows ``_insert_slot`` copies into the pool slot (positions past the
bucket keep stale K/V from the slot's earlier occupant, which no read
reaches: both attention backends mask positions past ``pos``).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.workload.trace import DEFAULT_TIERS, TierSet

# families whose prefill accepts per-row ``lengths`` (bucketed prompts are
# exact); the reference also buckets ssm/hybrid, which are not yet ported
_BUCKET_FAMILIES = ("dense",)


def pow2_bucket(n: int, lo: int = 1) -> int:
    """Smallest power of two >= n (and >= lo)."""
    b = lo
    while b < n:
        b <<= 1
    return b


def get_prefill_shapes(model: Model, max_seq: int, cache_dtype,
                       attn_backend: str) -> set:
    """The set of distinct prefill shapes seen by every replica of one
    (model, max_seq, cache_dtype, attn_backend): its size is the analogue
    of the reference's count of prefill compilations (a jitted prefill
    compiles once per shape; an eager one runs each shape's kernels from
    the first call). Kept on the Model instance, as the reference keeps its
    jit cache, so replicas of one model share one set."""
    cache = getattr(model, "_prefill_shapes", None)
    if cache is None:
        cache = {}
        object.__setattr__(model, "_prefill_shapes", cache)  # frozen
    return cache.setdefault((max_seq, str(cache_dtype), attn_backend), set())


def _timed_get(owner, tensors) -> list:
    """Blocking fetch of device ``tensors`` to numpy, accounted on
    ``owner``: bumps ``owner.syncs`` once and adds the blocked wall time to
    ``owner.sync_wait``."""
    t0 = time.perf_counter()
    out = [t.cpu().numpy() for t in tensors]
    owner.sync_wait += time.perf_counter() - t0
    owner.syncs += 1
    return out


@dataclasses.dataclass
class _AdmitPlans:
    """Host-side admission decisions for one engine step (no dispatches):
    ``bucketed`` groups share one pow2-bucket prefill each, ``singles`` are
    exact-length admits (requests carrying extras, replicas that do not
    bucket)."""
    bucketed: list          # [(slots, reqs)]
    singles: list           # [(slot, req)]
    expired: list = dataclasses.field(default_factory=list)
    # queue heads whose deadline already passed — popped without consuming
    # a slot (admitting them would waste a prefill on a request that could
    # emit at most one truncated token); retired directly into ``finished``


class TieredQueue:
    """Per-tier FIFO queues drained in weighted-deficit round-robin order.

    Each tier owns a FIFO deque and a deficit counter. ``peek``/``pop``
    implement classic DRR with a unit request cost: when no backlogged tier
    holds a full credit, every backlogged tier earns its quantum
    (``weight / max_weight``), then the highest-priority tier with credit
    supplies the next request. The top-weight tier therefore admits first
    (its quantum is exactly 1.0), while a weight-w tier is still guaranteed
    ~w/w_max of admissions under sustained higher-tier load — weighted
    fairness with a hard no-starvation bound. Deficits persist across ticks
    so short admission windows can't bias the long-run shares; an empty
    tier's banked credit resets (no burst debt).

    With a single tier the discipline degenerates to the plain FIFO deque
    this class replaced: same pops, same order, bit-identical streams.
    ``popleft``/``__iter__`` expose global arrival order for the drain and
    failure hand-back paths, which must not apply scheduling priority."""

    def __init__(self, tiers: TierSet):
        self.tiers = tiers
        self._qs = [deque() for _ in tiers.specs]
        self._deficit = [0.0] * len(tiers)
        wmax = max(float(w) for w in tiers.weights)
        self._quantum = [float(w) / wmax for w in tiers.weights]

    def __len__(self) -> int:
        return sum(len(q) for q in self._qs)

    def __bool__(self) -> bool:
        return any(self._qs)

    def __iter__(self):
        """All queued requests in global arrival order (rid tiebreak)."""
        return iter(sorted((r for q in self._qs for r in q),
                           key=lambda r: (r.arrival, r.rid)))

    def append(self, req):
        self._qs[self.tiers.index(getattr(req, "tier", "standard"))] \
            .append(req)

    def clear(self):
        for q in self._qs:
            q.clear()

    def popleft(self):
        """Earliest-arrival request across all tiers (hand-back order for
        drain/evacuate — deliberately NOT the scheduling order)."""
        cands = [q for q in self._qs if q]
        if not cands:
            raise IndexError("pop from an empty TieredQueue")
        best = min(cands, key=lambda q: (q[0].arrival, q[0].rid))
        return best.popleft()

    def depths(self) -> list:
        """Per-tier queue lengths (declaration order)."""
        return [len(q) for q in self._qs]

    def higher_waiting(self, tier_idx: int) -> bool:
        """Any queued work in a strictly higher-priority tier?"""
        rank = self.tiers._rank[tier_idx]
        return any(self._qs[t] for t in self.tiers.priority[:rank])

    def _head_tier(self, exclude) -> Optional[int]:
        live = [t for t in self.tiers.priority
                if self._qs[t] and t not in exclude]
        if not live:
            return None
        for t, q in enumerate(self._qs):     # empty tiers bank no credit
            if not q:
                self._deficit[t] = 0.0
        while True:
            for t in live:                   # priority order within a round
                if self._deficit[t] >= 1.0 - 1e-9:
                    return t
            for t in live:
                self._deficit[t] += self._quantum[t]

    def peek(self, exclude=()) -> Optional[tuple]:
        """(tier_idx, request) the next ``pop`` would return, or None.
        Idempotent: repeated peeks without a pop return the same head."""
        t = self._head_tier(exclude)
        return None if t is None else (t, self._qs[t][0])

    def pop(self, exclude=()):
        t = self._head_tier(exclude)
        if t is None:
            raise IndexError("pop from an empty TieredQueue")
        self._deficit[t] -= 1.0
        return self._qs[t].popleft()


def total_prefill_traces(engines) -> int:
    """Global count of distinct prefill shapes, deduped across replicas that
    share a count."""
    seen = {id(e._shapes): len(e._shapes) for e in engines}
    return sum(seen.values())


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new_tokens: int = 16
    eos_id: int = -1               # -1: never stop early
    arrival: float = 0.0
    tier: str = "standard"         # SLO tier name (see workload.trace)
    # deadline (absolute tick, None = no deadline): past it the request is
    # worthless to its client — in-flight slots retire through the existing
    # fleet/afleet ``rem <= 1`` rule (the host clamps the remaining-token
    # budget, see ``rem_tokens``; no new kernels, no extra dispatches) and
    # queued copies are culled at admission time. Deadlines are denominated
    # in ticks and enforced at one decode step per tick; a speed>1 replica's
    # extra sub-steps only ever retire it conservatively *earlier*.
    deadline_tick: Optional[float] = None
    # filled by the engine
    output: list = dataclasses.field(default_factory=list)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.finish_time is not None

    @property
    def expired(self) -> bool:
        """Finished by deadline expiry rather than on its own terms: the
        output was truncated — neither the token budget nor EOS ended it —
        and only the deadline clamp / queue cull truncates. The finish
        stamp can land *before* the deadline (a request admitted at tick t
        also decodes at tick t, outrunning the 1-token/tick clamp budget),
        so truncation, not ``finish_time``, is the signal. Never true
        without a deadline, so deadline-free workloads classify exactly
        as before."""
        return (self.deadline_tick is not None
                and self.finish_time is not None
                and len(self.output) < self.max_new_tokens
                and (not self.output or self.output[-1] != self.eos_id))

    def rem_tokens(self, clock: float) -> int:
        """Remaining-token budget at ``clock`` — the value the fleet/afleet
        retire rule consumes as ``rem``. Without a deadline this is exactly
        the historical ``max_new_tokens - len(output)``; with one, it is
        additionally clamped so the slot retires (``rem <= 1``) no later
        than the deadline tick. Both budgets decrement one per decode step,
        so a value seeded once into the async device operands stays the
        exact min at every later micro-step."""
        rem = self.max_new_tokens - len(self.output)
        if self.deadline_tick is not None:
            rem = min(rem, int(self.deadline_tick - clock) + 1)
        return rem

    def out_of_time(self, clock: float) -> bool:
        """Host twin of the deadline half of the device retire rule: at
        ``clock >= deadline_tick`` the deadline-clamped ``rem`` is <= 1, so
        the token appended at ``clock`` is the slot's last."""
        return self.deadline_tick is not None and clock >= self.deadline_tick

    def reset_progress(self):
        """Forget generation progress (replica failure -> re-queue)."""
        self.output = []
        self.first_token_time = None
        self.finish_time = None


class ReplicaEngine:
    """One model replica: a ``max_batch``-slot KV pool of ``max_seq``
    positions on ``device``, its tiered queue, and the admit / decode /
    retire loop (``step``). ``attn_backend`` is ``"kernel"`` (the CUDA
    kernels; their plain versions on the CPU) or ``"einsum"``."""

    def __init__(self, model: Model, params, *, max_batch: int = 4,
                 max_seq: int = 256, cache_dtype=torch.float32, rid: int = 0,
                 min_bucket: int = 8,
                 bucket_prompts: Optional[bool] = None, chunk_len: int = 0,
                 tiers: Optional[TierSet] = None,
                 attn_backend: str = "kernel", device="cuda"):
        if attn_backend not in ("kernel", "einsum"):
            raise ValueError(f"unknown attn_backend {attn_backend!r}")
        if chunk_len:
            raise NotImplementedError("chunked prefill (chunk_len > 0) is "
                                      "not yet ported")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine was asked to run on {self.device}")
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.cache_dtype = cache_dtype
        self.attn_backend = attn_backend
        self.rid = rid
        self.min_bucket = min_bucket
        self.cache = model.init_serve_state(max_batch, max_seq, cache_dtype,
                                            device=self.device)
        self.pos = np.zeros(max_batch, np.int32)       # next cache index
        self.last_tok = np.zeros(max_batch, np.int32)
        self.slots: list = [None] * max_batch
        self.tiers = tiers or DEFAULT_TIERS
        self.queue: TieredQueue = TieredQueue(self.tiers)
        self.clock = 0.0
        self.steps = 0
        self.syncs = 0                # blocking host syncs performed
        self.sync_wait = 0.0          # seconds spent blocked on the device
        self.prefill_dispatches = 0   # admission prefill calls issued
        if bucket_prompts is None:
            bucket_prompts = model.cfg.family in _BUCKET_FAMILIES
        self.bucket_prompts = bucket_prompts
        self._shapes = get_prefill_shapes(model, max_seq, cache_dtype,
                                          attn_backend)

    @property
    def prefill_traces(self) -> int:
        """Distinct prefill shapes seen by this replica's (shared) count."""
        return len(self._shapes)

    # ----------------------------------------------------------------- load
    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def load(self) -> int:
        return self.n_active + len(self.queue)

    def submit(self, req: Request):
        self.queue.append(req)

    # ------------------------------------------------------------- plumbing
    def _insert_slot(self, slot: int, small_state, row: int, prompt_len: int,
                     first_tok: int, req: Request):
        for name, big in self.cache.items():
            small = small_state[name]
            big[:, slot, :small.shape[2]].copy_(small[:, row])
        self.pos[slot] = prompt_len
        self.last_tok[slot] = first_tok
        self.slots[slot] = req

    def _admit_batch(self, slots: list, reqs: list, finished: list,
                     bucketed: bool):
        if bucketed:
            # a prompt longer than the KV pool keeps only its last
            # max_seq - 1 tokens (one slot must remain for generation)
            prompts = [r.prompt[-(self.max_seq - 1):] for r in reqs]
            lens = [len(p) for p in prompts]
            sb = min(pow2_bucket(max(lens), self.min_bucket), self.max_seq)
            kb = pow2_bucket(len(reqs))
            toks = np.zeros((kb, sb), np.int32)
            lengths = np.ones(kb, np.int32)    # pad rows: length-1 dummies
            for i, p in enumerate(prompts):
                toks[i, :len(p)] = p
                lengths[i] = len(p)
            batch = {"tokens": torch.from_numpy(toks).to(self.device),
                     "lengths": torch.from_numpy(lengths).to(self.device)}
            self._shapes.add(("bucketed", kb, sb))
        else:
            req = reqs[0]
            if getattr(req, "extras", None):
                raise NotImplementedError("requests with extras (vlm "
                                          "patches, audio frames) are not "
                                          "yet ported")
            # same overflow guard as the bucketed path
            prompt = req.prompt[-(self.max_seq - 1):]
            batch = {"tokens": torch.tensor([prompt], dtype=torch.int32,
                                            device=self.device)}
            self._shapes.add(("single", 1, len(prompt)))
        sb = batch["tokens"].shape[1]
        logits, small, plen = self.model.prefill(
            self.params, batch, cache_len=sb, cache_dtype=self.cache_dtype,
            attn_backend=self.attn_backend)
        self.prefill_dispatches += 1
        first, plen = _timed_get(self, (torch.argmax(logits, dim=-1), plen))
        for i, (slot, req) in enumerate(zip(slots, reqs)):
            tok = int(first[i])
            req.output.append(tok)
            req.first_token_time = self.clock
            if len(req.output) >= req.max_new_tokens or tok == req.eos_id \
                    or req.out_of_time(self.clock):
                req.finish_time = self.clock
                finished.append(req)
                continue
            self._insert_slot(slot, small, i, int(plen[i]), tok, req)

    # ------------------------------------------------------------ admission
    def plan_admission(self) -> _AdmitPlans:
        """Pop admittable queue heads into reserved slots without
        dispatching. Queue heads come out in the tiered weighted-deficit
        order (see ``TieredQueue``); consecutive bucketable heads group
        into one bucketed prefill, others become exact-length single
        admits, and heads past their deadline retire unserved."""
        plans = _AdmitPlans([], [])
        free = [i for i in range(self.max_batch) if self.slots[i] is None]
        while free:
            picked = self.queue.peek()
            if picked is None:
                break
            _, head = picked
            if head.out_of_time(self.clock):
                req = self.queue.pop()
                req.finish_time = self.clock
                plans.expired.append(req)
                continue
            if not self.bucket_prompts or getattr(head, "extras", None):
                plans.singles.append((free.pop(0), self.queue.pop()))
                continue
            group = []
            while len(group) < len(free):
                nxt = self.queue.peek()
                if nxt is None or getattr(nxt[1], "extras", None) \
                        or nxt[1].out_of_time(self.clock):
                    break
                group.append(self.queue.pop())
            plans.bucketed.append(([free.pop(0) for _ in group], group))
        return plans

    def _admit(self, finished: list):
        """Plan, then dispatch this engine's own bucketed / exact-length
        prefill calls."""
        plans = self.plan_admission()
        finished.extend(plans.expired)
        for slot, req in plans.singles:
            self._admit_batch([slot], [req], finished, bucketed=False)
        for slots, reqs in plans.bucketed:
            self._admit_batch(slots, reqs, finished, bucketed=True)

    # ------------------------------------------------------------- stepping
    def begin_step(self, dt: float = 1.0, admit: bool = True) -> list:
        """Tick phase 1: advance the clock and admit from the queue. Returns
        requests that completed at prefill time."""
        self.clock += dt
        finished: list = []
        if admit:
            self._admit(finished)
        return finished

    def finish_step(self) -> list:
        """Tick phase 2: one decode step for all active slots (empty slots
        decode garbage at their stale position, which nothing reads)."""
        if self.n_active == 0:
            return []
        toks = torch.from_numpy(self.last_tok[:, None].copy()).to(self.device)
        pos = torch.from_numpy(self.pos.copy()).to(self.device)
        logits, self.cache = self.model.decode(
            self.params, self.cache, toks, pos,
            attn_backend=self.attn_backend)
        self.steps += 1
        finished: list = []
        next_toks = _timed_get(self, (torch.argmax(logits, dim=-1),))[0]
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(next_toks[slot])
            req.output.append(tok)
            self.pos[slot] += 1
            self.last_tok[slot] = tok
            if (len(req.output) >= req.max_new_tokens or tok == req.eos_id
                    or self.pos[slot] >= self.max_seq - 1
                    or req.out_of_time(self.clock)):
                req.finish_time = self.clock
                finished.append(req)
                self.slots[slot] = None
        return finished

    def step(self, dt: float = 1.0) -> list:
        """Admit + one decode step for all active slots. Returns finished
        (including requests that completed at prefill time)."""
        finished = self.begin_step(dt)
        finished.extend(self.finish_step())
        return finished


def normalize_fractions(fr: np.ndarray, mask: Optional[np.ndarray] = None
                        ) -> np.ndarray:
    """Simplex-normalize routing fractions with a uniform fallback — the
    numpy twin of ``core.balancer._mask_normalize``. Non-finite or negative
    entries are zeroed; a zero/NaN sum falls back to uniform over the mask.
    An all-false mask (every node/cell down — a full blackout tick) returns
    uniform-over-none, i.e. all zeros: callers must treat a zero-sum result
    as "nothing can serve" and park arrivals (retry pool / pending) rather
    than divide by the mask count — the old fallback silently routed
    uniform over DEAD nodes."""
    fr = np.asarray(fr, np.float64)
    fr = np.where(np.isfinite(fr) & (fr > 0.0), fr, 0.0)
    if mask is not None:
        m = np.asarray(mask, np.float64) > 0.0
        if not m.any():
            return np.zeros(fr.shape[0], np.float64)
        fr = fr * m
    s = fr.sum()
    if s <= 1e-12:
        if mask is not None:
            m = (np.asarray(mask) > 0).astype(np.float64)
            return m / m.sum()
        return np.full(fr.shape[0], 1.0 / fr.shape[0])
    return fr / s


class ClusterFrontend:
    """Routes requests to standalone replicas via balancer fractions (or
    queue depth). ``fleet_batch=True`` (the reference's stacked fleet slab)
    and ``mesh`` are not yet ported and raise."""

    def __init__(self, replicas: list, policy: str = "lc",
                 fractions_fn=None, seed: int = 0, fleet_batch: bool = False,
                 fleet_prefill: Optional[bool] = None, mesh=None):
        if fleet_batch or fleet_prefill or mesh is not None:
            raise NotImplementedError("fleet-batched serving (FleetGroup) "
                                      "and mesh sharding are not yet ported")
        self.replicas = replicas
        self.policy = policy
        self.fractions_fn = fractions_fn
        self.rng = np.random.default_rng(seed)
        self.pending: deque = deque()
        self.finished: list = []
        self._rr = itertools.cycle(range(len(replicas)))

    def submit(self, req: Request):
        self.pending.append(req)

    def _route(self):
        while self.pending:
            req = self.pending.popleft()
            if self.policy == "rr":
                idx = next(self._rr)
            elif self.policy == "lc":
                loads = [r.load for r in self.replicas]
                idx = int(np.argmin(loads))
            elif self.policy == "fractions":
                fr = normalize_fractions(self.fractions_fn(self))
                idx = int(self.rng.choice(len(self.replicas), p=fr))
            else:
                raise ValueError(self.policy)
            self.replicas[idx].submit(req)

    def step(self, dt: float = 1.0):
        self._route()
        for r in self.replicas:
            self.finished.extend(r.step(dt))

    def run_until_drained(self, max_steps: int = 10_000):
        for _ in range(max_steps):
            self.step()
            if not self.pending and all(r.load == 0 for r in self.replicas):
                return
        raise RuntimeError("engine did not drain")
