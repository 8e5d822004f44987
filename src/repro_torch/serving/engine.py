"""Request-level serving engine: continuous batching over real model forwards
(the port of ``repro.serving.engine``: every family).

``ReplicaEngine`` runs one model replica: a slot-based KV pool on the
device, per-slot positions (the vector-``pos`` decode path),
admit-on-free-slot, greedy sampling, retire-on-EOS/max-tokens. Prompts are
right-padded to power-of-two length buckets and admitted in batched
prefill calls, so the prefill sees O(log max_seq * log max_batch) distinct
shapes in total (``prefill_traces`` counts them -- the analogue of the
reference's jit retrace count). Padded prefill is exact for the dense,
ssm, hybrid and hybrid_moe families: causal attention masks trailing pads,
padded steps get dt = 0 in the SSM scan (decay 1, no input), and
hybrid_moe's dropless experts route pads nowhere. A bucketed prefill's
batch also carries its real rows' lengths on the host (``host_lengths``):
hybrid_moe runs each row at its own length with them, so its bucket costs
what its prompts do; the other families ignore them. Prompts longer than
``max_seq - 1`` are truncated to their last ``max_seq - 1`` tokens at
admission (the KV pool can never overflow).

**MoE replicas admit exact-length prompts** one at a time, as in the
reference: expert capacity scales with the padded length, so a bucketed
prefill could drop other tokens than the prompt's own. Such a single
admit fetches its first token eagerly (one blocking sync, counted on the
replica) and, in a fleet, registers its slot in the group's device
operands (``FleetGroup.write_slot``); the async tick's decode around it is
unchanged.

**Requests with extras.** A vlm request carries ``extras =
{"patch_embeds": (1, P, d)}``, an audio request ``{"frame_embeds": (1,
Le, d)}`` (numpy or tensors; set as an attribute of the ``Request``, as in
the reference). They take the exact-length single admit: the extras join
the prefill's batch on the engine's device in the weights' dtype, copied
from pinned host memory without blocking (``stage_extras``). A vlm
pool holds ``max_seq + num_patches`` positions a row and its ``pos``
counts the patch prefix, so the retirement at ``pos >= max_seq - 1``
counts it too -- the reference's rule, kept for parity: a request whose
prefix and prompt reach ``max_seq - 1`` stops after its first decoded
token. Both families also serve as a fleet, as under the reference's
``ElasticClusterFrontend`` defaults: a member's single admit writes its
rows through ``FleetGroup.write_slot``, a vlm slab row holds ``max_seq +
num_patches`` positions, an audio row its self cache and the fixed-``Le``
cross K/V, and the fleet decode runs the cross pass at ``Le - 1`` as the
standalone decode does.

**SLO tiers.** Each replica's pending queue is a ``TieredQueue``: one FIFO
per priority class (``workload.trace.TierSet``), drained in weighted-deficit
round-robin order. The default single tier is a plain FIFO.

**Fleet-batched decode and admission.** Slot bookkeeping (the ``Request``
objects, host ``pos``/``last_tok`` mirrors, queues, clocks) lives on the
engine; the device cache lives either on the engine (standalone) or in a
``FleetGroup`` shared by every replica of the same ``(model, params,
max_batch, max_seq, cache_dtype, attn_backend, device)``. The reference
stacks the members' caches on a leading fleet axis and ``vmap``s one
replica's decode over it. Here the slab is *flat*: member f's slot s is
row ``f * max_batch + s`` of every leaf of one serve state -- an
``(L, cap * max_batch, S, G, hd)`` cache for dense, the ``(L, cap *
max_batch, H, P, N)`` SSM state and its conv window for ssm/hybrid -- so
one ``model.decode`` over ``cap * max_batch`` rows advances every member
at once (one ``flash_decode`` launch per attention layer for the whole
fleet). The greedy argmax and the retire rule (max-tokens / EOS /
cache-full) run on the device and come back as one small
``(cap, max_batch)`` pair. Members
of a group admit together: rows of one pow2 length bucket across all
members flatten into ONE prefill per distinct bucket shape, which writes
each row's state straight into its slab row (the attention caches over
the bucket's positions, the SSM and conv states whole).

The slab is preallocated and updated in place -- the stand-in for the
reference's jit buffer donation. Capacity grows in pow2 steps (a grow
allocates a new slab and copies the live rows once); a removed member's
rows are backfilled with the last member's rows in one copy per cache.
Rows that do not step in a round (heterogeneous speeds) are excluded from
the state write by index, so they keep their state bit for bit; the
prefill scatter writes only the real rows of a pow2-padded batch (the
reference drops the pad rows' out-of-range indices; here they are never
formed).

``ReplicaEngine.step()`` remains the standalone per-replica path and is the
parity oracle for the fleet path.

**Chunked prefill** (``chunk_len > 0``, the dense, ssm and hybrid families
with an f32 cache; any other cache or family silently keeps single-shot
prefill, as in the reference). A prompt longer than ``chunk_len`` reserves
a slot and a chunk cursor at admission and streams in fixed-size chunks,
one per engine step, interleaved with decode rounds: dense and hybrid
attention at the chunk's cache offset over the filled prefix
(``ops.flash_attention`` with ``q_offset``, reading the pool rows in
place), ssm/hybrid scans from the carried SSM state (``ops.ssd_scan`` with
``init_state``) and the carried conv window. All due chunk rows of a
replica -- of a fleet group, across its members -- advance in ONE chunk
dispatch, each row's state updated in place in its pool or slab row. A
mid-chunk slot is held out of decode: it is inactive in the decode
operands, and the decode writes only the rows it steps (the masked
variant's write index, restaged each round into the same fixed buffer,
so a new set of held rows replays the same graph). Two tier guards: a
lower-tier chunk start yields the last free slot while higher-priority
work waits, and under pressure at most one below-decoding-tier cursor
advances a step (``plan_admission`` / ``_chunk_due``). In async mode a
cursor advances at dispatch and the final chunk's first token commits at
the next reconcile. Chunk by chunk equals single-shot prefill.

**The int8 KV cache** (``cache_dtype="int8"``, the dense, moe and vlm
families; ssm, hybrid and audio raise as in the reference): the pool is
int8 with per-(token, head) f32 scales (``serving.kv_quant``); a prefill
quantizes its prompt once at the end, a decode quantizes each new token on
write and reads the pool through ``ops.flash_decode``, which dequantizes in
its loads. The four leaves ride the fleet slab, its growth, backfill and
``write_slot`` like the float pool's two.

**Decode graphs.** On a card every decode dispatch of the async fleet tick
and of a standalone replica replays a captured CUDA graph (``serving.
graphs``): the port's counterpart of the reference's jitted dispatch. The
fleet's graphs are keyed by (masked, micro-steps): the masked
variant of a sub-step round reads the stepping rows from fixed-size
device buffers (``_masks``: a (cap,) row mask and a (cap * B,) write
index, padded by repeating the movers' own rows, so a row written twice
gets the same value twice), and a slab growth drops every graph (a grow
reallocates the slab, the operands and the masks; a backfill on remove
copies in place). A standalone replica's graph reads its tokens and
positions from static buffers. On the CPU the same code runs eagerly.
The eager oracle is ``async_mode=False`` (``decode_round``'s blocking
path) and ``ReplicaEngine(decode_graph=False)``.

**Async tick contract.** With ``async_mode`` the fleet dispatch methods
never block on the device. The decode operands (``toks``/``pos``/``rem``/
``eos``/``active``, ``(cap, max_batch)`` each) live on the device next to
the slab and are advanced in place by the same dispatch (``ops``); a
dispatch's small outputs (next tokens, fused retire mask, stepped mask,
prefill first tokens) start their copy to pinned host memory right behind
it, and the host bookkeeping captured at dispatch time waits on
``pending``. All of it applies at ONE reconcile point per tick
(``FleetGroup.reconcile``: one wait, counted by ``syncs``), so the host's
work for tick t overlaps the device computing tick t's decode. Per-dispatch
operands built on the host go through one pinned staging copy
(``non_blocking``); nothing in the tick calls ``.item()``, ``.tolist()``
or ``.cpu()`` on a device tensor outside ``reconcile`` and the
exact-length admits' eager fetch. Token streams and
finish ticks are bit-identical to the eager oracle (``async_mode=False``),
only the host-side observation is one tick late. Membership churn
(scale-up joins, drain retire, failure) force-flushes pending results
first.

``decode_block=K`` fuses K decode micro-steps into one dispatch (on a card
one graph of K micro-steps: the reference's ``lax.scan``), engaged by the
reference's rules: only with the async tick, on a single-round tick that
admitted nothing (no pending prefill, no single admit) over the full group.
One block counts as one dispatch and covers the next K - 1 ticks' decode;
its (K, cap, B) results reconcile at the block's end with finish clocks
``dispatch_clock + k``, so an admission landing inside the window starts
decoding at its end (a lag of at most K - 1 ticks).

**Fleet-mesh sharding.** A ``FleetGroup`` built with ``mesh=`` (a
``launch.mesh.Mesh`` with a ``fleet`` axis, and any of the data-like axes
``pod``, ``data``, ``expert`` and ``model``) splits its slab rows, its
async operands and masks over N row blocks, one per index of ``fleet`` x
the data-like axes: block d owns a contiguous run of ``cap / N`` fleet
rows, with the weights copied once to its lead device, and capacity
grows as ``N * pow2_bucket(ceil(F / N))`` so the rows always divide; pad
rows stay inactive. Over a ``model`` axis each block's state leaves are
split by heads over the block's ``model`` devices (``sharding.
HeadLayout``: kv heads, SSM heads and conv channels, as the reference's
``fleet_slab_shardings`` lays them out); the model runs each
head-independent site on each device's block and the rest on the lead
(``layers.per_shard``). One host loop drives every block (the
reference's single controller): a logical decode dispatch runs the same
decode, or its captured graph, once a block, the fleet prefill and chunk
dispatches run on the blocks that own their rows, and a logical sync
gathers the blocks' results into one host buffer behind one wait. The
counters count logical dispatches and syncs, so streams, finish clocks
and counts equal the unsharded group's (``FleetGroup``'s shard
contract).
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core.tree import tree_map
from repro_torch.device import host_to_device, resolve_device
from repro_torch.distributed.sharding import HeadLayout
from repro_torch.models.layers import HeadBlocks
from repro_torch.models.model import SEQ_LEAVES, Model
from repro_torch.serving.graphs import DecodeGraphs
from repro_torch.workload.trace import DEFAULT_TIERS, TierSet

# the mesh axes a fleet group's slab rows split over (fleet major, then
# the reference's data-like axes) and the one that splits each replica's
# heads
_ROW_AXES = ("fleet", "pod", "data", "expert")
_HEAD_AXIS = "model"

# families whose prefill accepts per-row ``lengths`` (bucketed prompts are
# exact). moe is absent: expert capacity scales with the padded bucket;
# hybrid_moe's dropless experts route a bucket's pads nowhere
_BUCKET_FAMILIES = ("dense", "ssm", "hybrid", "hybrid_moe")
# families with a chunked-prefill continuation (cache-offset attention for
# dense, carried ssm/conv state for ssm/hybrid); moe is absent for the
# same capacity reason
_CHUNK_FAMILIES = ("dense", "ssm", "hybrid")


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


def _write_state(state: dict, rows, small: dict, src) -> None:
    """Write prefill state rows ``src`` of ``small`` into rows ``rows``
    (axis 1: an int or an index tensor) of the serve state ``state``, in
    place. The attention caches (``SEQ_LEAVES``: their axis 2 is the
    sequence) take the prompt's positions only; the SSM and conv states
    are written whole."""
    for name, big in state.items():
        v = small[name][:, src]
        if name in SEQ_LEAVES:
            big[:, rows, :small[name].shape[2]] = v
        else:
            big[:, rows] = v


def _pack_chunk_rows(items: list, chunk_len: int) -> tuple:
    """Host arrays of one chunk dispatch from its work items ``(row, toks,
    off, ln, fresh)`` (``row`` the state row): tokens (n, chunk_len),
    offsets, lengths and rows (n,), and the state rows of the items that
    start a prompt (``fresh``). The reference pads the batch to a power of
    two with dummy rows whose writes drop; here only the real rows run."""
    n = len(items)
    toks = np.zeros((n, chunk_len), np.int32)
    offs = np.zeros(n, np.int32)
    lens = np.ones(n, np.int32)
    rows = np.zeros(n, np.int32)
    for i, (row, t, off, ln, _) in enumerate(items):
        toks[i], offs[i], lens[i], rows[i] = t, off, ln, row
    fresh = np.asarray([row for row, *_, fr in items if fr], np.int32)
    return toks, offs, lens, rows, fresh


def _chunk_dispatch(model, params, state: dict, device, attn_backend: str,
                    items: list, chunk_len: int) -> tuple:
    """ONE chunk step over the state rows of ``items`` (see
    ``_pack_chunk_rows``), in place: the carried (non-sequence) state of a
    row that starts its prompt is zeroed first (a first chunk must not see
    the slot's previous occupant's SSM/conv state; its attention cache
    beyond the frontier is masked, as in slot reuse), one chunk advances,
    and the greedy argmax is fused. Returns the device (first token, pos)
    (n,) int32 each."""
    toks, offs, lens, rows, fresh = _pack_chunk_rows(items, chunk_len)
    toks, offs, lens, rows, fresh = _stage(device, toks, offs, lens, rows,
                                           fresh)
    if fresh.numel():
        for name, t in state.items():
            if name not in SEQ_LEAVES:
                t[:, fresh.long()] = 0
    logits, _, pos = model.prefill_chunk(params, state, toks, offs, lens,
                                         rows=rows, attn_backend=attn_backend)
    return torch.argmax(logits, dim=-1).to(torch.int32), pos


def _whole(leaf) -> torch.Tensor:
    """A slab leaf's view as one tensor: a HeadBlocks view gathered on its
    lead device, a tensor as it is."""
    return leaf.gather() if isinstance(leaf, HeadBlocks) else leaf


def _timed_get(owner, tensors) -> list:
    """Blocking fetch of device ``tensors`` to numpy, accounted on
    ``owner``: bumps ``owner.syncs`` once and adds the blocked wall time,
    the ``engine.sync_wait`` span's, to ``owner.sync_wait``."""
    with telemetry.span("engine.sync_wait", into=(owner, "sync_wait")):
        out = [t.cpu().numpy() for t in tensors]
    owner.syncs += 1
    return out


def _stage(device: torch.device, *arrays) -> list:
    """Host integer/bool arrays as int32 tensors on ``device``, through ONE
    pinned staging copy (one host-to-device copy per dispatch rather than
    one per operand). Returns views of the staged buffer in ``arrays``'
    shapes."""
    flat = np.concatenate([np.asarray(a, np.int32).ravel() for a in arrays])
    buf = host_to_device(flat, device)
    out, o = [], 0
    for a in arrays:
        n = int(np.size(a))
        out.append(buf[o:o + n].view(tuple(np.shape(a))))
        o += n
    return out


def stage_extras(extras: dict, device: torch.device, dtype) -> dict:
    """A request's extras (host arrays or tensors) on ``device`` in
    ``dtype``. A host value goes through pinned memory and a non-blocking
    copy (as ``_stage`` does), then is cast on the device; a tensor already
    on a device is only cast."""
    out = {}
    for name, val in extras.items():
        t = val if isinstance(val, torch.Tensor) \
            else torch.from_numpy(np.array(val, order="C"))
        if t.device.type == "cpu" and device.type == "cuda":
            t = t.contiguous().pin_memory().to(device, non_blocking=True)
        out[name] = t.to(device, dtype)
    return out


def _stage_into(dst, *arrays) -> None:
    """Host arrays into the fixed device tensors ``dst`` (a captured graph
    reads them by address): one staging copy, then a device copy each."""
    for d, src in zip(dst, _stage(dst[0].device, *arrays)):
        d.copy_(src)


def _on(device: torch.device):
    """Make ``device`` current for the block: a CUDA launch goes to the
    current device's stream. Nothing to do on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class _Pending:
    """A dispatched device result not yet applied on the host. ``pieces``
    [(index, outputs)] are the dispatch's small outputs, one piece a shard
    that ran (one piece unsharded); ``index`` (a tuple of slices) places a
    piece's outputs in the host arrays of ``like`` [(shape, dtype)], which
    are zero where no piece lands (default: a lone piece's own shapes,
    index ``()``). ``host`` holds those arrays: on a card, pinned host
    tensors whose copies were enqueued right behind the dispatch (before
    any later replay can overwrite a graph's outputs), with one ``ready``
    event recorded after them on each piece's device;
    on the CPU, a lone piece's outputs themselves (the CPU runs eagerly:
    each dispatch's outputs are new tensors), or a CPU gather. ``meta`` is
    the host bookkeeping context captured at dispatch time (engines,
    slots, requests and the dispatch-time clocks that stamp TTFT/finish)."""

    def __init__(self, kind: str, pieces: list, meta: list, like=None):
        self.kind = kind  # "decode" | "block" | "prefill" | "chunk" | "fetch"
        self.meta = meta
        self.ready = []
        if like is None:
            like = [(a.shape, a.dtype) for a in pieces[0][1]]
        cuda = pieces[0][1][0].device.type == "cuda"
        lone = len(pieces) == 1 and all(       # one piece covers them whole
            tuple(a.shape) == tuple(shape)
            for a, (shape, _) in zip(pieces[0][1], like))
        if lone and not cuda:
            self.host = list(pieces[0][1])
            return
        alloc = torch.empty if lone else torch.zeros
        self.host = [alloc(shape, dtype=dt, pin_memory=cuda)
                     for shape, dt in like]
        for index, outs in pieces:
            with _on(outs[0].device):
                for h, a in zip(self.host, outs):
                    h[index].copy_(a, non_blocking=cuda)
                if cuda:
                    self.ready.append(torch.cuda.Event())
                    self.ready[-1].record()


def _timed_wait(owner, pend: list) -> list:
    """The reconcile's one blocking wait: every pending result's host copy,
    as numpy, accounted on ``owner`` like ``_timed_get`` (one sync)."""
    with telemetry.span("engine.sync_wait", into=(owner, "sync_wait")):
        for p in pend:
            for ev in p.ready:
                ev.synchronize()
        out = [[h.numpy() for h in p.host] for p in pend]
    owner.syncs += 1
    return out


def _init_ops(cap: int, batch: int, device: torch.device) -> dict:
    """Fresh device-resident decode operands for an async fleet slab:
    per-slot next-token / cache-position / remaining-budget / eos-id /
    active-mask, (cap, batch) each. Inactive rows are never read through
    (``active`` masks them)."""
    full = lambda v, dt: torch.full((cap, batch), v, dtype=dt, device=device)
    return {"toks": full(0, torch.int32), "pos": full(0, torch.int32),
            "rem": full(1, torch.int32), "eos": full(-1, torch.int32),
            "active": full(False, torch.bool)}


@dataclasses.dataclass
class _ChunkCursor:
    """Per-slot chunked-prefill progress: the (truncated) prompt streaming
    into the slot and how many tokens earlier chunks consumed."""
    req: "Request"
    prompt: list
    consumed: int = 0


@dataclasses.dataclass
class _AdmitPlans:
    """Host-side admission decisions for one engine step (no dispatches):
    ``bucketed`` groups share one pow2-bucket prefill each, ``singles`` are
    exact-length admits (requests carrying extras, replicas that do not
    bucket). Chunk starts are recorded directly on the engine's cursor
    table."""
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
    retire loop (``step``). ``speed`` is its relative decode speed (the
    elastic frontend runs speed>1 replicas several sub-steps per tick).
    ``attn_backend`` is ``"pallas"`` (the CUDA kernels; their plain versions
    on the CPU) or ``"einsum"``. On a card the standalone decode step
    replays a captured graph; ``decode_graph=False`` keeps it eager (the
    oracle). ``chunk_len`` and ``cache_dtype="int8"``: see the module
    docstring."""

    def __init__(self, model: Model, params, *, max_batch: int = 4,
                 max_seq: int = 256, cache_dtype=torch.float32, rid: int = 0,
                 speed: float = 1.0, min_bucket: int = 8,
                 bucket_prompts: Optional[bool] = None, chunk_len: int = 0,
                 tiers: Optional[TierSet] = None,
                 attn_backend: str = "pallas", device="cuda",
                 decode_graph: bool = True):
        if attn_backend not in ("pallas", "einsum"):
            raise ValueError(f"unknown attn_backend {attn_backend!r}")
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
        self.speed = speed
        self.min_bucket = min_bucket
        self.draining = False         # drained replicas admit nothing new
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
        self._fleet: Optional["FleetGroup"] = None  # device state owner
        self._fleet_row = -1                        # when fleet-batched
        self._chunks: dict = {}     # slot -> _ChunkCursor (mid-chunk slots)
        if bucket_prompts is None:
            bucket_prompts = model.cfg.family in _BUCKET_FAMILIES
        self.bucket_prompts = bucket_prompts
        # chunked admission needs a continuation and an f32 cache: the int8
        # codec quantizes whole prompts at prefill end, and a bf16 cache
        # would make chunked attention read back rounded K/V (and re-round
        # the carried conv state each chunk) where single-shot prefill
        # attends the unrounded values -- the reference drops chunk_len then
        if chunk_len and (model.cfg.family not in _CHUNK_FAMILIES
                          or cache_dtype != torch.float32):
            chunk_len = 0
        self.chunk_len = int(chunk_len)
        self._shapes = get_prefill_shapes(model, max_seq, cache_dtype,
                                          attn_backend)
        # the standalone decode step: its operands' fixed device buffers
        # (the held variant's write index too: the slots that decode, padded
        # by repeating them) and its graphs, keyed by the addresses of the
        # pool they were captured on
        self._step_ops = {
            name: torch.zeros(shape, dtype=torch.int32, device=self.device)
            for name, shape in (("toks", (max_batch, 1)),
                                ("pos", (max_batch,)),
                                ("write", (max_batch,)))}
        self.graphs = DecodeGraphs(self.device, eager=not decode_graph)
        self._captured_on = ()

    @property
    def fleet_key(self) -> tuple:
        """Replicas with equal keys can share one fleet slab."""
        return (id(self.model), id(self.params), self.max_batch,
                self.max_seq, str(self.cache_dtype), self.attn_backend,
                str(self.device))

    @property
    def prefill_traces(self) -> int:
        """Distinct prefill shapes seen by this replica's (shared) count."""
        return len(self._shapes)

    # ----------------------------------------------------------------- load
    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def n_decoding(self) -> int:
        """Slots in the decode phase (occupied and not mid-chunk-prefill)."""
        return sum(s is not None and i not in self._chunks
                   for i, s in enumerate(self.slots))

    @property
    def load(self) -> int:
        return self.n_active + len(self.queue)

    def tier_load(self) -> list:
        """Per-tier unfinished count on this replica (declaration order):
        queued + in-flight slots."""
        counts = self.queue.depths()
        for req in self.slots:
            if req is not None:
                counts[self.tiers.index(req.tier)] += 1
        return counts

    def submit(self, req: Request):
        self.queue.append(req)

    def evacuate(self) -> list:
        """Failure path: pull every in-flight + queued request off this
        replica (generation progress is lost) so the caller can re-queue."""
        lost = [r for r in self.slots if r is not None] + list(self.queue)
        self.slots = [None] * self.max_batch
        self.queue.clear()
        self._chunks.clear()
        for r in lost:
            r.reset_progress()
        return lost

    # ------------------------------------------------------------- plumbing
    def _insert_slot(self, slot: int, small_state, row: int, prompt_len: int,
                     first_tok: int, req: Request):
        if self._fleet is not None:
            self._fleet.write_slot(self._fleet_row, slot, small_state, row,
                                   req=req, prompt_len=prompt_len)
        else:
            _write_state(self.cache, slot, small_state, row)
        self.pos[slot] = prompt_len
        self.last_tok[slot] = first_tok
        self.slots[slot] = req

    def _admit_batch(self, slots: list, reqs: list, finished: list,
                     bucketed: bool):
        # a fleet member's prefill runs where its rows live (the shard
        # that owns them, under a mesh; its state in that shard's head
        # blocks over a model axis)
        device, params, layout = (self.device, self.params, None) \
            if self._fleet is None \
            else self._fleet.placement(self._fleet_row)
        with _on(device):
            self._admit_on(device, params, slots, reqs, finished, bucketed,
                           layout)

    def _admit_on(self, device, params, slots: list, reqs: list,
                  finished: list, bucketed: bool, layout=None):
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
            host = lengths[:len(reqs)]
            toks, lengths = _stage(device, toks, lengths)
            batch = {"tokens": toks, "lengths": lengths,
                     "host_lengths": host}
            self._shapes.add(("bucketed", kb, sb))
        else:
            req = reqs[0]
            # same overflow guard as the bucketed path
            prompt = req.prompt[-(self.max_seq - 1):]
            batch = {"tokens": _stage(device, [prompt])[0]}
            shape = ("single", 1, len(prompt))
            # per-request extras (a vlm request's patch_embeds, an audio
            # request's frame_embeds) join the batch on the prefill's
            # device, in the weights' dtype
            extras = stage_extras(getattr(req, "extras", None) or {},
                                  device, params["embed"].dtype)
            batch.update(extras)
            self._shapes.add(shape + tuple((name,) + tuple(t.shape)
                                           for name, t in extras.items()))
        sb = batch["tokens"].shape[1]
        logits, small, plen = self.model.prefill(
            params, batch, cache_len=sb, cache_dtype=self.cache_dtype,
            attn_backend=self.attn_backend, shard_fn=layout)
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

    def commit_admit(self, slots: list, reqs: list, first, plen,
                     finished: list):
        """Apply a fleet-prefill result: the slab rows were already written
        on the device, so only the host bookkeeping (first token, TTFT,
        retire or register) remains. A request that finishes at prefill
        time leaves stale state in the slab -- harmless, like slot reuse."""
        for i, (slot, req) in enumerate(zip(slots, reqs)):
            tok = int(first[i])
            req.output.append(tok)
            req.first_token_time = self.clock
            if len(req.output) >= req.max_new_tokens or tok == req.eos_id \
                    or req.out_of_time(self.clock):
                req.finish_time = self.clock
                finished.append(req)
                continue
            self.pos[slot] = int(plen[i])
            self.last_tok[slot] = tok
            self.slots[slot] = req

    # ------------------------------------------------------------ admission
    def _chunkable(self, req: Request) -> bool:
        return (self.chunk_len > 0
                and getattr(req, "extras", None) is None
                and min(len(req.prompt), self.max_seq - 1) > self.chunk_len)

    def plan_admission(self) -> _AdmitPlans:
        """Pop admittable queue heads into reserved slots without
        dispatching -- the shared host half of the standalone and the
        fleet-batched admission paths. Queue heads come out in the tiered
        weighted-deficit order (see ``TieredQueue``); chunk-eligible
        prompts reserve a slot and a chunk cursor (their first chunk runs
        in this step's chunk round), but a lower-tier chunk start yields
        the last free slot while higher-priority work waits (it would hold
        the slot for ceil(len / chunk) ticks); consecutive bucketable heads
        group into one bucketed prefill, others become exact-length single
        admits, and heads past their deadline retire unserved. A draining
        replica admits nothing."""
        plans = _AdmitPlans([], [])
        if self.draining:
            return plans
        free = [i for i in range(self.max_batch) if self.slots[i] is None]
        deferred: set = set()         # tiers whose chunk start yielded
        while free:
            picked = self.queue.peek(deferred)
            if picked is None:
                break
            tier_idx, head = picked
            if head.out_of_time(self.clock):
                req = self.queue.pop(deferred)
                req.finish_time = self.clock
                plans.expired.append(req)
                continue
            if self._chunkable(head):
                if len(free) == 1 and self.queue.higher_waiting(tier_idx):
                    deferred.add(tier_idx)    # leave the slot for premium
                    continue
                req = self.queue.pop(deferred)
                slot = free.pop(0)
                self.slots[slot] = req
                self._chunks[slot] = _ChunkCursor(
                    req, req.prompt[-(self.max_seq - 1):])
                continue
            if not self.bucket_prompts or getattr(head, "extras", None):
                plans.singles.append((free.pop(0), self.queue.pop(deferred)))
                continue
            group = []
            while len(group) < len(free):
                nxt = self.queue.peek(deferred)
                if nxt is None or getattr(nxt[1], "extras", None) \
                        or self._chunkable(nxt[1]) \
                        or nxt[1].out_of_time(self.clock):
                    break
                group.append(self.queue.pop(deferred))
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

    # --------------------------------------------------------------- chunks
    def _chunk_due(self) -> list:
        """Mid-chunk slots due to advance this step, tier-throttled: a
        cursor whose tier is strictly below some decoding slot's tier is
        "pressured" (its chunk compute would stretch the tick every one of
        those slots' next token waits on), and under pressure at most ONE
        such cursor advances a step (the highest-priority, lowest-slot
        one). Cursors at or above every decoding tier (and everything in
        single-tier mode) advance unthrottled."""
        slots = sorted(self._chunks)
        if len(self.tiers) <= 1 or not slots:
            return slots
        decoding = [self.tiers.rank(req.tier)
                    for s, req in enumerate(self.slots)
                    if req is not None and s not in self._chunks]
        if not decoding:
            return slots
        best = min(decoding)                  # rank 0 = highest priority
        rank = lambda s: self.tiers.rank(self._chunks[s].req.tier)
        calm = [s for s in slots if rank(s) <= best]
        pressured = sorted((s for s in slots if rank(s) > best),
                           key=lambda s: (rank(s), s))
        return sorted(calm + pressured[:1])

    def _chunk_rows(self) -> list:
        """This step's chunk work items:
        (slot, toks (chunk_len,), offset, true_len, fresh, final)."""
        rows = []
        for slot in self._chunk_due():
            cur = self._chunks[slot]
            off = cur.consumed
            ln = min(self.chunk_len, len(cur.prompt) - off)
            toks = np.zeros(self.chunk_len, np.int32)
            toks[:ln] = cur.prompt[off:off + ln]
            rows.append((slot, toks, off, ln, off == 0,
                         off + ln >= len(cur.prompt)))
        return rows

    def commit_chunk(self, slot: int, first_tok, pos, final: bool,
                     finished: list):
        """Apply one chunk result: advance the cursor, or -- on the final
        chunk -- record the first generated token and hand the slot to the
        decode phase (or retire it at once)."""
        cur = self._chunks[slot]
        if not final:
            cur.consumed += self.chunk_len
            return
        del self._chunks[slot]
        req = cur.req
        tok = int(first_tok)
        req.output.append(tok)
        req.first_token_time = self.clock
        if len(req.output) >= req.max_new_tokens or tok == req.eos_id \
                or req.out_of_time(self.clock):
            req.finish_time = self.clock
            finished.append(req)
            self.slots[slot] = None
            return
        self.pos[slot] = int(pos)
        self.last_tok[slot] = tok

    def _chunk_step(self, finished: list):
        """Advance every due mid-chunk slot by one chunk in ONE dispatch
        (a fleet member's through its group's slab)."""
        rows = self._chunk_rows()
        if not rows:
            return
        if self._fleet is not None:
            self._fleet._dispatch_fleet_chunk(
                [(self,) + row for row in rows], finished)
            return
        first, pos = _chunk_dispatch(
            self.model, self.params, self.cache, self.device,
            self.attn_backend, [(slot, t, off, ln, fr)
                                for slot, t, off, ln, fr, _ in rows],
            self.chunk_len)
        self.prefill_dispatches += 1
        self._shapes.add(("chunk", pow2_bucket(len(rows)), self.chunk_len,
                          self.max_batch))
        first, pos = _timed_get(self, (first, pos))
        for i, (slot, t, off, ln, fr, fin) in enumerate(rows):
            self.commit_chunk(slot, first[i], pos[i], fin, finished)

    # ------------------------------------------------------------- stepping
    def begin_step(self, dt: float = 1.0, admit: bool = True) -> list:
        """Tick phase 1: advance the clock, admit from the queue and advance
        the mid-chunk slots one chunk. Returns requests that completed at
        prefill time. With ``admit=False`` only the clock moves -- the
        caller batches admission across the fleet via
        ``FleetGroup.admit_round``."""
        self.clock += dt
        finished: list = []
        if admit:
            self._admit(finished)
            self._chunk_step(finished)
        return finished

    def finish_step(self) -> list:
        """Tick phase 2: one decode step for all active slots but the
        mid-chunk ones (empty slots decode garbage at their stale position,
        which nothing reads; a mid-chunk slot's state is not written)."""
        if self._fleet is not None:    # device state lives in the fleet slab
            return self._fleet.decode_round({id(self)})
        if self.n_decoding == 0:
            return []
        held = bool(self._chunks)
        host = [self.last_tok[:, None], self.pos]
        if held:
            write = [s for s in range(self.max_batch) if s not in self._chunks]
            host.append(np.resize(np.asarray(write, np.int32),
                                  self.max_batch))
        _stage_into((self._step_ops["toks"], self._step_ops["pos"],
                     self._step_ops["write"])[:len(host)], *host)
        pool = tuple(c.data_ptr() for c in self.cache.values())
        if pool != self._captured_on:  # a pool handed back by a fleet
            self.graphs.drop()
            self._captured_on = pool
        nxt = self.graphs.run("decode_hold" if held else "decode",
                              lambda: self._decode_next(held))
        self.steps += 1
        finished: list = []
        next_toks = _timed_get(self, nxt)[0]
        for slot, req in enumerate(self.slots):
            if req is None or slot in self._chunks:
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

    def _decode_next(self, held: bool = False) -> tuple:
        """One decode of the pool from the static operands (in place):
        each slot's greedy next token. ``held``: only the slots of the
        write index buffer write their state (mid-chunk slots keep
        theirs)."""
        logits, _ = self.model.decode(
            self.params, self.cache, self._step_ops["toks"],
            self._step_ops["pos"], attn_backend=self.attn_backend,
            write_rows=self._step_ops["write"] if held else None)
        return (torch.argmax(logits, dim=-1),)

    def commit_decode(self, next_toks: np.ndarray, done: np.ndarray) -> list:
        """Apply one eager fleet decode result to the host bookkeeping.
        ``next_toks``/``done`` are this engine's (B,) rows of the batched
        fetch; the retire mask was computed on the device."""
        finished: list = []
        stepped = False
        for slot, req in enumerate(self.slots):
            if req is None or slot in self._chunks:
                continue
            stepped = True
            tok = int(next_toks[slot])
            req.output.append(tok)
            self.pos[slot] += 1
            self.last_tok[slot] = tok
            if done[slot]:
                req.finish_time = self.clock
                finished.append(req)
                self.slots[slot] = None
        if stepped:
            self.steps += 1
        return finished

    def apply_decode(self, nxt: np.ndarray, done: np.ndarray,
                     stepped: np.ndarray, clock: float) -> list:
        """Apply one *async* fleet decode result at reconcile time: the
        device's ``stepped`` mask (not the possibly-stale host view) says
        which slots advanced, and ``clock`` is the dispatch-time clock that
        stamps finishes."""
        idx = np.flatnonzero(stepped)
        if idx.size == 0:
            return []
        self.pos[idx] += 1
        self.last_tok[idx] = nxt[idx]
        self.steps += 1
        finished: list = []
        for s in idx:
            req = self.slots[s]
            req.output.append(int(nxt[s]))
            if done[s]:
                req.finish_time = clock
                finished.append(req)
                self.slots[s] = None
        return finished

    def step(self, dt: float = 1.0) -> list:
        """Admit + one decode step for all active slots. Returns finished
        (including requests that completed at prefill time)."""
        finished = self.begin_step(dt)
        finished.extend(self.finish_step())
        return finished


class _Shard:
    """One row block of a fleet group's slab: fleet rows [lo, lo + rows)
    (fleet row lo + i is its local row i; member f's slot s is local slab
    row (f - lo) * max_batch + s) on ``devices``, the block's devices
    along the mesh's ``model`` axis (one without one). The lead,
    ``device`` (model index 0), holds the weights, the async decode
    operands, the masked dispatch's masks and the decode graphs, and runs
    the work that is not split by heads. The slab's leaves are plain
    tensors on the lead with one device, else ``layers.HeadBlocks`` laid
    out by ``layout`` (``sharding.HeadLayout``), which the prefills also
    take as their ``shard_fn``. The decode graphs capture a step only
    when every device of the block is one device (a step over several
    cards crosses devices inside each layer, and runs eagerly)."""

    def __init__(self, devices: list, params, layout=None):
        self.devices = devices
        self.device = devices[0]
        self.params = params
        self.layout = layout
        self.lo = 0                 # first fleet row owned
        self.rows = 0               # fleet rows owned
        self.slab = None            # {leaf: (L, rows * max_batch, ...)}
        self.ops = None             # async operands, (rows, max_batch) each
        self.masks = None           # the masked dispatch's rows / write
        self.graphs = DecodeGraphs(self.device,
                                   eager=len(set(devices)) > 1)

    def zeros(self, name: str, shape, dtype):
        """A zero slab leaf of ``shape``, laid out."""
        if self.layout is None:
            return torch.zeros(shape, dtype=dtype, device=self.device)
        return self.layout.zeros(name, shape, dtype)

    def slab_bytes(self) -> list:
        """The slab's bytes on each of ``devices``, in order."""
        out = [0] * len(self.devices)
        for leaf in (self.slab or {}).values():
            parts = leaf.parts if isinstance(leaf, HeadBlocks) else [leaf]
            for m, t in enumerate(parts):
                out[m] += t.numel() * t.element_size()
        return out


class FleetGroup:
    """The device state of same-shape replicas in one flat slab, advanced
    with one decode dispatch per round (see the module docstring).

    ``slab`` holds ``k`` and ``v`` of shape (L, cap * max_batch, S, G, hd):
    member f (``members[f]``, its ``_fleet_row``) owns rows
    [f * max_batch, (f + 1) * max_batch). ``cap`` grows in pow2 steps;
    rows past the members are pad rows that decode throwaway state in a
    full round and are overwritten when a replica joins. Removing a member
    backfills its rows with the last member's rows, so live rows stay dense.

    ``admit_round`` is the admission twin of ``decode_round``: members'
    bucketed admit rows of the same pow2 length bucket flatten into ONE
    prefill per distinct bucket, writing K/V straight into the slab, and
    all members' due chunk rows advance in ONE chunk dispatch over the
    slab rows in place. ``prefill_dispatches`` mirrors ``dispatches``.

    With ``async_mode`` the dispatch methods never block: device results
    queue on ``pending`` and the deferred host bookkeeping applies at the
    next ``reconcile()`` -- one blocking sync per tick (``syncs``), with
    the decode operands persistent on the device (``ops``). Each async
    decode dispatch runs through ``graphs`` (a captured CUDA graph on a
    card); ``decode_block=K`` fuses K micro-steps into one on the ticks
    the reference's rules allow (module docstring). ``decode_steps``
    counts the micro-steps run (K a block).

    **Shard contract** (``mesh`` with a ``fleet`` axis; the reference's,
    ``src/repro/serving/engine.py`` ``FleetGroup``). The slab rows split
    over N row blocks, one per index of ``fleet`` x the data-like axes
    (``pod``, ``data``, ``expert``; ``launch.mesh.Mesh.row_blocks``, fleet
    major): block d (``parts[d]``) owns the contiguous fleet rows
    [d * cap / N, (d + 1) * cap / N), whole members, with its part of the
    async operands and masks and its own graphs on its lead device; the
    weights are copied once to each distinct lead device. ``cap = N *
    pow2_bucket(ceil(F / N))`` (``_cap_for``), so the rows, and ``cap *
    max_batch``, always divide; pad rows are inactive and never in
    ``movers``. The reference splits the fleet axis over ``fleet`` and
    each replica's slots over the data-like axes; the port's flat slab
    keeps a member's slots together and splits members over both, so a
    device may hold other rows than the reference's device of the same
    coordinates (the values and every count are the same). Over a
    ``model`` axis of M devices (``heads``) each block's leaves are
    ``layers.HeadBlocks`` over its M devices, split where the reference
    splits them (the kv heads of every attention cache, the SSM heads,
    the conv channels; the same head ranges) and whole on each device
    where M does not divide the dim, as the reference replicates them.
    A logical dispatch (decode, prefill, chunk) runs once on each block
    that holds its rows (a full decode round on every block), under the
    block's lead device, its head-independent work once a ``model``
    device, and counts once in ``dispatches`` / ``prefill_dispatches``;
    its small results gather into one host buffer behind one wait (one
    ``syncs``). A growth re-partitions the rows (a row may move to
    another block) and drops every graph; a backfill on remove may copy a
    row across devices. A block captures its decode steps as graphs only
    when its devices are one device (``_Shard``). Streams and finish
    clocks equal the unsharded group's. Any other axis (``seq``, ``pipe``,
    ...) names no part of the slab, which the reference therefore
    replicates over it: each row block runs on index 0 of every such axis
    (``Mesh.row_blocks``), whose copy holds the values every replica
    holds, and the devices at its other indices hold no slab. Unsharded,
    ``parts`` is one block on ``device``, and
    ``slab``, ``ops``, ``graphs`` are its."""

    def __init__(self, model: Model, params, *, max_batch: int, max_seq: int,
                 cache_dtype=torch.float32, async_mode: bool = False,
                 decode_block: int = 1, attn_backend: str = "pallas",
                 mesh=None, device="cuda"):
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is None:
            blocks = [[self.device]]
        else:
            if "fleet" not in mesh.axis_names:
                raise ValueError(f"FleetGroup mesh needs a 'fleet' axis, "
                                 f"got {mesh.axis_names}")
            blocks = [[resolve_device(d) for d in b]
                      for b in mesh.row_blocks(_ROW_AXES, _HEAD_AXIS)]
        self.model = model
        self.params = params
        copies = {params["embed"].device: params}
        for b in blocks:
            if b[0] not in copies:     # the weights, once a lead device
                copies[b[0]] = tree_map(lambda t, d=b[0]: t.to(d), params)
        self.shards = len(blocks)
        self.heads = len(blocks[0])     # devices a replica's heads span
        self.parts = [_Shard(b, copies[b[0]], HeadLayout(mesh, b)
                             if len(b) > 1 else None) for b in blocks]
        # most slab bytes each device of each row block ever held
        self.peak_bytes = [[0] * self.heads for _ in blocks]
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.cache_dtype = cache_dtype
        self.attn_backend = attn_backend
        self.members: list = []     # ReplicaEngine; fleet row == list index
        self.cap = 0                # allocated fleet rows
        self.peak_rows = 0          # most slab rows ever allocated
        self.dispatches = 0         # fleet decode dispatches issued
        self.prefill_dispatches = 0  # fleet admission dispatches issued
        self.async_mode = bool(async_mode)
        self.decode_block = max(1, int(decode_block))
        self.decode_steps = 0       # decode micro-steps run (K a block)
        # the shards' own runs behind those counts (equal to them
        # unsharded): each shard's decode micro-steps and admission
        # dispatches, so a run's kernel launches follow from them
        self.shard_steps = 0
        self.shard_prefills = 0
        self.pending: list = []     # _Pending device results, unapplied
        self._stash: list = []      # finishes from forced flushes (churn)
        self._admitted = False      # a single admit landed this tick
        self._block_credit = 0      # ticks already covered by a block
        self.syncs = 0              # blocking host syncs performed
        self.sync_wait = 0.0        # seconds spent blocked on the device
        self._shapes = get_prefill_shapes(model, max_seq, cache_dtype,
                                          attn_backend)

    def __len__(self) -> int:
        return len(self.members)

    # ------------------------------------------------------------ sharding
    def _one(self) -> _Shard:
        if self.shards != 1:
            raise AttributeError("a sharded group keeps its slab, operands, "
                                 "masks and graphs per shard (parts)")
        return self.parts[0]

    @property
    def slab(self):
        """The unsharded group's slab, {leaf: (L, cap * max_batch, ...)}."""
        return self._one().slab

    @property
    def ops(self):
        """The unsharded group's async decode operands, (cap, B) each."""
        return self._one().ops

    @property
    def _masks(self):
        return self._one().masks

    @property
    def graphs(self) -> DecodeGraphs:
        return self._one().graphs

    def graph_stats(self) -> dict:
        """Decode-graph counts summed over the shards."""
        out: dict = {}
        for p in self.parts:
            for k, n in p.graphs.stats().items():
                out[k] = out.get(k, 0) + n
        return out

    def _cap_for(self, rows: int) -> int:
        """Slab capacity for ``rows`` members: the next power of two, or,
        sharded, N times the next power of two of ceil(rows / N), so the
        fleet rows always divide over the shards."""
        if self.shards == 1:
            return pow2_bucket(rows)
        return self.shards * pow2_bucket(-(-rows // self.shards))

    def _rows(self, f: int) -> slice:
        """Slab rows of fleet row ``f`` (logical; unsharded, the slab's)."""
        return slice(f * self.max_batch, (f + 1) * self.max_batch)

    def _where(self, f: int) -> tuple:
        """(the shard owning fleet row ``f``, its local fleet row)."""
        p = self.parts[f // (self.cap // self.shards)]
        return p, f - p.lo

    def placement(self, f: int) -> tuple:
        """(device, weights, head layout or None) of the shard owning
        fleet row ``f``: where a member's own prefill runs (its rows' state
        is written there)."""
        p = self._where(f)[0]
        return p.device, p.params, p.layout

    def _by_shard(self, rows) -> list:
        """[(shard, [indices into ``rows``])] for the shards owning the
        fleet rows ``rows``, in shard order."""
        per = self.cap // self.shards
        out: dict = {}
        for i, f in enumerate(rows):
            out.setdefault(f // per, []).append(i)
        return [(self.parts[d], out[d]) for d in sorted(out)]

    def _copy_rows(self, dst: _Shard, di: int, src: _Shard, si: int,
                   n: int):
        """Fleet rows [si, si + n) of shard ``src`` into rows [di, di + n)
        of shard ``dst`` (slab and operands; any two devices)."""
        B = self.max_batch
        for name, s in dst.slab.items():
            s[:, di * B:(di + n) * B].copy_(
                src.slab[name][:, si * B:(si + n) * B])
        if dst.ops is not None:
            for name, o in dst.ops.items():
                o[di:di + n].copy_(src.ops[name][si:si + n])

    def _grow(self, cap: int, like: dict):
        """Reallocate every shard for ``cap`` fleet rows and copy the live
        rows over (under a mesh a row may change shard). The graphs read
        the slab, the operands and the masks by address: all are new."""
        B, per = self.max_batch, cap // self.shards
        old = [copy.copy(p) for p in self.parts] if self.cap else []
        live = len(self.members)
        for d, p in enumerate(self.parts):
            p.lo, p.rows = d * per, per
            p.slab = {n: p.zeros(n, (c.shape[0], per * B)
                                 + tuple(c.shape[2:]), c.dtype)
                      for n, c in like.items()}
            self.peak_bytes[d] = [max(a, b) for a, b in
                                  zip(self.peak_bytes[d], p.slab_bytes())]
            if self.async_mode:
                p.ops = _init_ops(per, B, p.device)
                p.masks = {
                    "rows": torch.zeros(per, dtype=torch.bool,
                                        device=p.device),
                    "write": torch.zeros(per * B, dtype=torch.int32,
                                         device=p.device)}
                p.graphs.drop()
        for o in old:
            for p in self.parts:
                a = max(o.lo, p.lo)
                b = min(o.lo + o.rows, p.lo + p.rows, live)
                if a < b:
                    self._copy_rows(p, a - p.lo, o, a - o.lo, b - a)
        self.cap = cap
        self.peak_rows = max(self.peak_rows, cap * B)

    def _fetch(self, pieces: list, like: list) -> list:
        """Eager results of one logical dispatch, gathered from its shards
        (see ``_Pending``) behind one blocking wait: numpy arrays."""
        return _timed_wait(self, [_Pending("fetch", pieces, [], like)])[0]

    # -------------------------------------------------------------- members
    def add(self, eng: ReplicaEngine):
        """Copy ``eng``'s cache into the slab (any in-flight slot state
        rides along, so replicas can join mid-generation). Pending results
        apply first so the operand seed sees current host state."""
        assert eng._fleet is None, "engine already belongs to a fleet"
        if self.pending:
            self._stash += self.reconcile(force=True)
        row = len(self.members)
        if row >= self.cap:
            self._grow(self._cap_for(row + 1), eng.cache)
        part, i = self._where(row)
        B = self.max_batch
        for n, s in part.slab.items():
            s[:, i * B:(i + 1) * B].copy_(eng.cache[n])
        if self.async_mode:
            self._seed_ops_row(row, eng)
        eng.cache = None
        eng.graphs.drop()
        eng._fleet, eng._fleet_row = self, row
        self.members.append(eng)

    def _seed_ops_row(self, row: int, eng: ReplicaEngine):
        """Initialize the device operands of a joining member from its host
        mirrors (it may carry in-flight slots mid-generation)."""
        B = self.max_batch
        rem = np.zeros(B, np.int32)
        eos = np.full(B, -1, np.int32)
        act = np.zeros(B, np.int32)
        for s, req in enumerate(eng.slots):
            if req is not None and s not in eng._chunks:
                act[s] = 1
                rem[s] = req.rem_tokens(eng.clock)
                eos[s] = req.eos_id
        part, i = self._where(row)
        vals = _stage(part.device, eng.last_tok, eng.pos, rem, eos, act)
        for name, v in zip(("toks", "pos", "rem", "eos", "active"), vals):
            part.ops[name][i] = v.to(part.ops[name].dtype)

    def remove(self, eng: ReplicaEngine, restore: bool = True):
        """Detach ``eng``; with ``restore`` its slab rows are copied back
        onto the engine, on the engine's device (drain hand-back),
        otherwise dropped (failure). Pending results apply first (host
        mirrors must be current before a row moves)."""
        if self.pending:
            self._stash += self.reconcile(force=True)
        row = eng._fleet_row
        assert eng._fleet is self and self.members[row] is eng
        part, i = self._where(row)
        B = self.max_batch
        if restore:
            eng.cache = {n: _whole(s[:, i * B:(i + 1) * B]).clone().to(
                eng.device) for n, s in part.slab.items()}
        last = self.members.pop()
        if last is not eng:          # backfill the hole with the last rows
            src, si = self._where(len(self.members))
            self._copy_rows(part, i, src, si, 1)
            last._fleet_row = row
            self.members[row] = last
        eng._fleet, eng._fleet_row = None, -1

    # -------------------------------------------------------------- slots
    def write_slot(self, f: int, slot: int, small_state, row: int,
                   req: Optional[Request] = None, prompt_len: int = 0):
        """Copy prefill output row ``row`` into member ``f``'s slot (the
        per-replica admission path; fleet admission scatters inside
        ``_dispatch_fleet_prefill`` instead). In async mode the slot also
        registers in the device operands (``req``'s first token was already
        fetched by that path)."""
        part, i = self._where(f)
        _write_state(part.slab, i * self.max_batch + slot, small_state, row)
        if self.async_mode and req is not None:
            # fill_ takes the value as a kernel argument: an item
            # assignment would copy it from pageable memory, a blocking
            # sync for each operand on a card
            o = part.ops
            o["toks"][i, slot].fill_(int(req.output[-1]))
            o["pos"][i, slot].fill_(int(prompt_len))
            o["rem"][i, slot].fill_(req.rem_tokens(self.members[f].clock))
            o["eos"][i, slot].fill_(int(req.eos_id))
            o["active"][i, slot].fill_(True)
            # single admits bypass ``pending`` (their sync was eager), so
            # they veto a fused block separately
            self._admitted = True

    # -------------------------------------------------------------- admit
    @telemetry.spanned("engine.admit_round")
    def admit_round(self, stepping_ids=None) -> list:
        """One fused admission step for every member (or the ``id(engine)``
        subset in ``stepping_ids``): plan each member's admissions on the
        host, then flatten same-length-bucket admit rows into one prefill
        per distinct bucket and all due chunk rows into one chunk
        dispatch. Exact-length single admits keep the per-request path.
        Returns requests finished at prefill time."""
        movers = [e for e in self.members
                  if stepping_ids is None or id(e) in stepping_ids]
        finished: list = []
        buckets: dict = {}       # sb -> [(engine, slot, req, prompt)] rows
        chunk_rows: list = []    # (engine, slot, toks, off, ln, fresh, final)
        for e in movers:
            plans = e.plan_admission()
            finished.extend(plans.expired)
            for slot, req in plans.singles:
                e._admit_batch([slot], [req], finished, bucketed=False)
            for slots, reqs in plans.bucketed:
                prompts = [r.prompt[-(self.max_seq - 1):] for r in reqs]
                # the length bucket is chosen per member group exactly like
                # the standalone path; rows of the same bucket then flatten
                # into one fleet-wide batch
                sb = min(pow2_bucket(max(len(p) for p in prompts),
                                     e.min_bucket), self.max_seq)
                buckets.setdefault(sb, []).extend(
                    (e, s, r, p) for s, r, p in zip(slots, reqs, prompts))
            chunk_rows.extend((e,) + row for row in e._chunk_rows())
        for sb, entries in sorted(buckets.items()):
            self._dispatch_fleet_prefill(sb, entries, finished)
        if chunk_rows:
            self._dispatch_fleet_chunk(chunk_rows, finished)
        return finished

    @telemetry.spanned("engine.fleet_prefill")
    def _dispatch_fleet_prefill(self, sb: int, entries: list,
                                finished: list):
        """ONE prefill for every same-bucket admit across the fleet: the
        (K, sb) batch (K pow2-padded with length-1 dummy rows) runs the
        same row-independent prefill as the standalone path, and the n
        real rows' K/V scatter into their slab rows (member row * B +
        slot). Under a mesh each shard runs the prefill of the rows it
        owns. Async: the admitted slots also activate in the device
        operands, so this tick's decode consumes their first token without
        a host sync. Counts each shard's real prompt tokens
        (``engine.prefill_tokens``) and the token slots its prefill
        computes, K x sb (``engine.prefill_slots``)."""
        n, B = len(entries), self.max_batch
        pieces, at = [], {}
        for part, idx in self._by_shard([e._fleet_row
                                         for e, *_ in entries]):
            m, K = len(idx), pow2_bucket(len(idx))
            toks = np.zeros((K, sb), np.int32)
            lens = np.ones(K, np.int32)         # pad rows: length-1 dummies
            flat = np.zeros(m, np.int32)
            rems = np.zeros(m, np.int32)
            eoss = np.full(m, -1, np.int32)
            for j, i in enumerate(idx):
                e, slot, req, p = entries[i]
                at[i] = len(at)
                toks[j, :len(p)] = p
                lens[j] = len(p)
                flat[j] = (e._fleet_row - part.lo) * B + slot
                rems[j] = req.rem_tokens(e.clock) - 1
                eoss[j] = req.eos_id
            host = lens[:m]
            with _on(part.device):
                toks, lens, rows, rems, eoss = _stage(part.device, toks, lens,
                                                      flat, rems, eoss)
                logits, small, plen = self.model.prefill(
                    part.params, {"tokens": toks, "lengths": lens,
                                  "host_lengths": host},
                    cache_len=sb, cache_dtype=self.cache_dtype,
                    attn_backend=self.attn_backend, shard_fn=part.layout)
                first = torch.argmax(logits, dim=-1).to(torch.int32)
                _write_state(part.slab, rows, small, slice(0, m))
                if self.async_mode:
                    head = first[:m]
                    for name, v in (("toks", head), ("pos", plen[:m]),
                                    ("rem", rems), ("eos", eoss),
                                    ("active", (rems >= 1) & (head != eoss))):
                        part.ops[name].view(-1)[rows] = \
                            v.to(part.ops[name].dtype)
            a = len(at) - m
            pieces.append(((slice(a, a + m),), (first[:m], plen[:m])))
            self.shard_prefills += 1
            telemetry.count("engine.prefill_tokens",
                            sum(len(entries[i][3]) for i in idx))
            telemetry.count("engine.prefill_slots", K * sb)
        self.prefill_dispatches += 1
        self._shapes.add(("afleet_prefill" if self.async_mode
                          else "fleet_prefill", pow2_bucket(n), sb, self.cap,
                          B))
        if self.async_mode:
            meta = []
            for i, (e, slot, req, p) in enumerate(entries):
                e.slots[slot] = req      # reserve now; commit at reconcile
                meta.append((at[i], e, slot, req, len(p), e.clock))
            self.pending.append(_Pending(
                "prefill", [(ix, outs[:1]) for ix, outs in pieces], meta,
                [((n,), torch.int32)]))
            return
        first, plen = self._fetch(pieces, [((n,), torch.int32)] * 2)
        for i, (e, slot, req, p) in enumerate(entries):
            k = at[i]
            e.commit_admit([slot], [req], first[k:k + 1], plen[k:k + 1],
                           finished)

    @telemetry.spanned("engine.fleet_chunk")
    def _dispatch_fleet_chunk(self, chunk_rows: list, finished: list):
        """ONE chunk dispatch for every due chunk row across the fleet (one
        per distinct ``chunk_len`` of the members), each row's state
        advanced in place in its slab row (member row * B + slot; under a
        mesh, on the shard that owns it). Async: a cursor advances at
        dispatch (its advance is host-known); a row's final chunk
        activates the slot in the device operands and its first token
        commits at the next reconcile."""
        B = self.max_batch
        by_width: dict = {}
        for item in chunk_rows:
            by_width.setdefault(item[0].chunk_len, []).append(item)
        for C, items in sorted(by_width.items()):
            pieces, at = [], {}
            for part, idx in self._by_shard([it[0]._fleet_row
                                             for it in items]):
                local = []
                for i in idx:
                    e, slot, t, off, ln, fr, _ = items[i]
                    at[i] = len(at)
                    local.append(((e._fleet_row - part.lo) * B + slot, t, off,
                                  ln, fr))
                with _on(part.device):
                    first, pos = _chunk_dispatch(
                        self.model, part.params, part.slab, part.device,
                        self.attn_backend, local, C)
                    if self.async_mode:
                        self._activate_finals(part, [items[i] for i in idx],
                                              first, pos)
                a = len(at) - len(idx)
                pieces.append(((slice(a, a + len(idx)),), (first, pos)))
                self.shard_prefills += 1
            self.prefill_dispatches += 1
            self._shapes.add(("afleet_chunk" if self.async_mode
                              else "fleet_chunk", pow2_bucket(len(items)), C,
                              self.cap, B))
            n = len(items)
            if not self.async_mode:
                first, pos = self._fetch(pieces, [((n,), torch.int32)] * 2)
                for i, (e, slot, t, off, ln, fr, fin) in enumerate(items):
                    e.commit_chunk(slot, first[at[i]], pos[at[i]], fin,
                                   finished)
                continue
            meta = []
            for i, (e, slot, t, off, ln, fr, fin) in enumerate(items):
                cur = e._chunks[slot]
                if not fin:              # the cursor advance is host-known
                    cur.consumed += e.chunk_len
                    continue
                del e._chunks[slot]      # the slot stays reserved
                meta.append((at[i], e, slot, cur.req, off + ln, e.clock))
            if meta:
                self.pending.append(_Pending(
                    "chunk", [(ix, outs[:1]) for ix, outs in pieces], meta,
                    [((n,), torch.int32)]))

    def _activate_finals(self, part: _Shard, items: list, first, pos):
        """Async chunk dispatch on ``part``: the slots whose final chunk
        ran (``items`` in dispatch order) activate in its operands."""
        B = self.max_batch
        sel, flat, rems, eoss = [], [], [], []
        for j, (e, slot, t, off, ln, fr, fin) in enumerate(items):
            if fin:
                req = e._chunks[slot].req
                sel.append(j)
                flat.append((e._fleet_row - part.lo) * B + slot)
                rems.append(req.rem_tokens(e.clock) - 1)
                eoss.append(req.eos_id)
        if not sel:
            return
        sel, idx, rems, eoss = _stage(part.device, sel, flat, rems, eoss)
        head = first[sel.long()]
        for name, v in (("toks", head), ("pos", pos[sel.long()]),
                        ("rem", rems), ("eos", eoss),
                        ("active", (rems >= 1) & (head != eoss))):
            part.ops[name].view(-1)[idx] = v.to(part.ops[name].dtype)

    # -------------------------------------------------------------- decode
    def _fleet_core(self, part: _Shard, toks, pos, rem, eos, active,
                    rows=None, write=None):
        """One decode of every slab row of ``part``: toks/pos/rem/eos/
        active (rows, B) device tensors. Returns the next greedy token per
        slot and the fused retire mask, the device twin of the host rule in
        ``ReplicaEngine.finish_step``: after this token a slot is done when
        it reached max_new_tokens (rem <= 1), emitted EOS, or its next
        write index would hit the end of the cache. With ``rows`` (rows,)
        only those fleet rows step: ``write`` (their slab rows) limits the
        state write, so the others keep theirs."""
        logits, _ = self.model.decode(
            part.params, part.slab, toks.reshape(-1, 1), pos.reshape(-1),
            attn_backend=self.attn_backend, write_rows=write)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).view(
            part.rows, self.max_batch)
        done = active & ((rem <= 1) | (nxt == eos)
                         | (pos + 1 >= self.max_seq - 1))
        if rows is not None:
            done = done & rows[:, None]
        return nxt, done

    def _row_masks(self, movers: list) -> tuple:
        """Host (cap,) stepping-row mask and the slab rows the round
        writes: the movers' rows but their mid-chunk slots (held: their
        carried state must not advance on a garbage token)."""
        rows = np.zeros(self.cap, np.int32)
        write = []
        for e in movers:
            rows[e._fleet_row] = 1
            base = e._fleet_row * self.max_batch
            write.extend(base + s for s in range(self.max_batch)
                         if s not in e._chunks)
        return rows, np.asarray(write, np.int32)

    def _shard_masks(self, part: _Shard, rows, write) -> tuple:
        """``part``'s slice of ``_row_masks``: its (rows,) stepping mask
        and the local slab rows it writes."""
        lo, B = part.lo * self.max_batch, self.max_batch
        w = write[(write >= lo) & (write < lo + part.rows * B)] - lo
        return rows[part.lo:part.lo + part.rows], w

    @telemetry.spanned("engine.decode_round")
    def decode_round(self, stepping_ids=None, allow_block: bool = False
                     ) -> list:
        """One fused decode step for every member (or the ``id(engine)``
        subset in ``stepping_ids``). Returns finished requests. Eager: one
        dispatch plus one small (cap, B) host fetch. Async: one dispatch,
        no sync (results apply at the next ``reconcile``), and with
        ``allow_block`` a K-micro-step block may engage on a tick that
        admitted nothing -- covering the next K - 1 ticks' decode. Under a
        mesh a masked round runs only on the shards holding a stepping
        row."""
        movers = [e for e in self.members
                  if stepping_ids is None or id(e) in stepping_ids]
        if self.async_mode:
            return self._decode_round_async(movers, allow_block)
        if not movers or not any(e.n_decoding for e in movers):
            return []
        cap, B = self.cap, self.max_batch
        toks = np.zeros((cap, B), np.int32)
        pos = np.zeros((cap, B), np.int32)
        rem = np.ones((cap, B), np.int32)
        eos = np.full((cap, B), -1, np.int32)
        active = np.zeros((cap, B), np.int32)
        for e in movers:
            f = e._fleet_row
            toks[f] = e.last_tok
            pos[f] = e.pos
            for s, req in enumerate(e.slots):
                if req is not None and s not in e._chunks:
                    active[f, s] = 1
                    rem[f, s] = req.rem_tokens(e.clock)
                    eos[f, s] = req.eos_id
        masked = len(movers) < len(self.members) \
            or any(e._chunks for e in movers)
        if masked:
            rows, write = self._row_masks(movers)
        pieces, computed = [], 0
        for part in self.parts:
            span = slice(part.lo, part.lo + part.rows)
            host = [a[span] for a in (toks, pos, rem, eos, active)]
            if masked:
                r, w = self._shard_masks(part, rows, write)
                if not w.size:
                    continue
                host += [r, w]
            computed += part.rows * B
            with _on(part.device):
                dev = _stage(part.device, *host)
                r = w = None
                if masked:
                    r, w = dev[5].bool(), dev[6]
                out = self._fleet_core(part, *dev[:4], dev[4].bool(), r, w)
            pieces.append(((span,), out))
        self.dispatches += 1
        self.decode_steps += 1
        self.shard_steps += len(pieces)
        telemetry.count("engine.decode_rows_computed", computed)
        telemetry.count("engine.decode_rows_stepped", int(active.sum()))
        nxt, done = self._fetch(pieces, [((cap, B), torch.int32),
                                         ((cap, B), torch.bool)])
        finished: list = []
        for e in movers:
            f = e._fleet_row
            finished.extend(e.commit_decode(nxt[f], done[f]))
        return finished

    def _decode_round_async(self, movers: list, allow_block: bool) -> list:
        """Sync-free decode round: the operands already live on the device
        and advance in place; only the masks go up, staged into the fixed
        mask buffers -- the stepping rows (heterogeneous speeds) and the
        rows the round writes (without the mid-chunk slots, which stay
        inactive in the operands). One replay a shard (one graph of K
        micro-steps for a block); results queue on ``pending``."""
        if self._block_credit > 0:      # a fused block covers this tick
            self._block_credit -= 1
            return []
        if not movers or not any(e.n_decoding for e in movers):
            return []
        if any(p.kind in ("decode", "block") for p in self.pending):
            raise RuntimeError("a decode of this group is still pending: "
                               "its outputs would be overwritten")
        full = len(movers) == len(self.members)
        held = any(e._chunks for e in self.members)
        meta = [(e, e._fleet_row, e.clock) for e in movers]
        # fused-block engagement, the reference's rules: only on ticks with
        # no admissions at all -- ``pending`` holds this tick's fleet
        # prefills and chunks (the tick-start reconcile cleared the previous
        # window) and ``_admitted`` the single admits -- over the full group
        # with no chunk cursor open. Queued work behind a FULL slab does not
        # veto it: an admission landing inside the window starts decoding
        # at its end (lag <= K - 1 ticks)
        admitted, self._admitted = self._admitted, False
        K = self.decode_block
        steps = K if (allow_block and K > 1 and full and not held
                      and not self.pending and not admitted) else 1
        masked = not full or any(e._chunks for e in movers)
        if masked:
            rows, write = self._row_masks(movers)
        pieces, computed = [], 0
        for part in self.parts:
            span = slice(part.lo, part.lo + part.rows)
            with _on(part.device):
                if masked:
                    r, w = self._shard_masks(part, rows, write)
                    if not w.size:
                        continue
                    with telemetry.span("engine.stage_masks"):
                        _stage_into((part.masks["rows"],
                                     part.masks["write"]), r,
                                    np.resize(w, part.rows * self.max_batch))
                out = part.graphs.run(
                    (masked, steps),
                    lambda p=part: self._micro_steps(p, steps, masked))
            pieces.append(((span,) if steps == 1 else (slice(None), span),
                           out))
            computed += part.rows * self.max_batch * steps
        self.dispatches += 1
        self.decode_steps += steps
        self.shard_steps += steps * len(pieces)
        telemetry.count("engine.decode_rows_computed", computed)
        if steps > 1:
            self._block_credit = steps - 1
        shape = (self.cap, self.max_batch) if steps == 1 \
            else (steps, self.cap, self.max_batch)
        self.pending.append(_Pending(
            "block" if steps > 1 else "decode", pieces, meta,
            [(shape, torch.int32), (shape, torch.bool), (shape, torch.bool)]))
        return []

    def _micro_steps(self, part: _Shard, K: int, masked: bool) -> tuple:
        """K async decode micro-steps over ``part``'s slab rows, the device
        twin of ``ReplicaEngine.apply_decode`` each: the operands advance
        in place (a slot retired at micro-step k is inactive from k + 1).
        Reads only fixed tensors (slab, ``ops``, ``masks``): a graph's
        body. Returns (next tokens, retire mask, stepped mask), (rows, B)
        each, stacked (K, rows, B) when K > 1."""
        o = part.ops
        rows = part.masks["rows"] if masked else None
        write = part.masks["write"] if masked else None
        outs = []
        for _ in range(K):
            nxt, done = self._fleet_core(part, o["toks"], o["pos"], o["rem"],
                                         o["eos"], o["active"], rows, write)
            stepped = o["active"].clone() if rows is None else \
                o["active"] & rows[:, None]
            inc = stepped.to(torch.int32)
            o["toks"].copy_(torch.where(stepped, nxt, o["toks"]))
            o["pos"].add_(inc)
            o["rem"].sub_(inc)
            o["active"].logical_and_(~done)
            outs.append((nxt, done, stepped))
        if K == 1:
            return outs[0]
        return tuple(torch.stack(x) for x in zip(*outs))

    # ----------------------------------------------------------- reconcile
    def take_stash(self) -> list:
        """Drain finishes produced by forced mid-tick flushes (membership
        churn) without touching still-pending results."""
        out = list(self._stash)
        self._stash.clear()
        return out

    @telemetry.spanned("engine.reconcile")
    def reconcile(self, force: bool = False) -> list:
        """The ONE blocking host sync per tick: wait for every pending
        result together and apply the deferred host bookkeeping in dispatch
        order (prefill first tokens before the same tick's decode tokens --
        the exact replay of the eager host effects, one tick late). Returns
        newly finished requests, stamped with their dispatch-time clocks.
        While a decode block still covers upcoming ticks the wait is
        deferred (fewer than one sync a tick) unless ``force``d by
        membership churn."""
        # mutate the stash in place: callers flush via
        # ``self._stash += self.reconcile(...)`` and a reassignment here
        # would strand their appends on the orphaned old list (the in-place
        # target resolves BEFORE this call runs)
        finished: list = list(self._stash)
        self._stash.clear()
        if not self.pending or (self._block_credit > 0 and not force):
            return finished
        pend, self.pending = self.pending, []
        for p, vals in zip(pend, _timed_wait(self, pend)):
            if p.kind == "decode":
                self._apply_decode(vals, p.meta, finished)
            elif p.kind == "block":
                self._apply_block(vals, p.meta, finished)
            else:                    # "prefill" and final-"chunk" commits
                self._apply_admit(vals[0], p.meta, finished)
        return finished

    def _apply_decode(self, arrays, meta: list, finished: list):
        nxt, done, stepped = arrays
        telemetry.count("engine.decode_rows_stepped", int(stepped.sum()))
        for e, row, clock in meta:
            finished.extend(e.apply_decode(nxt[row], done[row], stepped[row],
                                           clock))

    def _apply_block(self, arrays, meta: list, finished: list):
        nxt, done, stepped = arrays                  # (K, cap, B)
        telemetry.count("engine.decode_rows_stepped", int(stepped.sum()))
        for k in range(nxt.shape[0]):                # micro-step k: clock + k
            for e, row, clock in meta:
                finished.extend(e.apply_decode(nxt[k, row], done[k, row],
                                               stepped[k, row], clock + k))

    def _apply_admit(self, first, meta: list, finished: list):
        """Deferred ``commit_admit`` / final-chunk ``commit_chunk``: the
        slot was reserved at dispatch (and a non-final chunk's cursor
        advanced there); now the first generated token, the TTFT stamp and
        the finish-at-prefill rule apply. ``pos`` in the meta is the
        host-known cache frontier (the prompt length, or the last chunk's
        offset + length)."""
        for i, e, slot, req, pos, clock in meta:
            tok = int(first[i])
            req.output.append(tok)
            req.first_token_time = clock
            if len(req.output) >= req.max_new_tokens or tok == req.eos_id \
                    or req.out_of_time(clock):
                req.finish_time = clock
                finished.append(req)
                e.slots[slot] = None
                continue
            e.pos[slot] = pos
            e.last_tok[slot] = tok


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
    """Routes requests to replicas via balancer fractions (or queue depth).

    ``fleet_batch=True`` stacks same-shape replicas into ``FleetGroup``s so a
    ``step`` issues one decode dispatch per group instead of one per replica.
    ``fleet_prefill`` (default: follows ``fleet_batch``) batches admission
    the same way; set it False to keep per-replica admission as the parity
    oracle. ``mesh`` (a ``launch.mesh.Mesh`` with a ``fleet`` axis) splits
    every group's slab rows over its row blocks and each replica's heads
    over its ``model`` axis (``FleetGroup``)."""

    def __init__(self, replicas: list, policy: str = "lc",
                 fractions_fn=None, seed: int = 0, fleet_batch: bool = False,
                 fleet_prefill: Optional[bool] = None, mesh=None):
        self.replicas = replicas
        self.mesh = mesh
        self.policy = policy
        self.fractions_fn = fractions_fn
        self.rng = np.random.default_rng(seed)
        self.pending: deque = deque()
        self.finished: list = []
        self._rr = itertools.cycle(range(len(replicas)))
        self.fleets: dict = {}
        self.fleet_prefill = fleet_batch if fleet_prefill is None \
            else (fleet_prefill and fleet_batch)
        if fleet_batch:
            for eng in replicas:
                g = self.fleets.get(eng.fleet_key)
                if g is None:
                    g = self.fleets[eng.fleet_key] = FleetGroup(
                        eng.model, eng.params, max_batch=eng.max_batch,
                        max_seq=eng.max_seq, cache_dtype=eng.cache_dtype,
                        attn_backend=eng.attn_backend, mesh=mesh,
                        device=eng.device)
                g.add(eng)

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
        if not self.fleets:
            for r in self.replicas:
                self.finished.extend(r.step(dt))
            return
        for r in self.replicas:
            self.finished.extend(r.begin_step(
                dt, admit=r._fleet is None or not self.fleet_prefill))
        if self.fleet_prefill:
            for g in self.fleets.values():
                self.finished.extend(g.admit_round())
        for g in self.fleets.values():
            self.finished.extend(g.decode_round())
        for r in self.replicas:          # replicas outside any fleet
            if r._fleet is None:
                self.finished.extend(r.finish_step())

    def run_until_drained(self, max_steps: int = 10_000):
        for _ in range(max_steps):
            self.step()
            if not self.pending and all(r.load == 0 for r in self.replicas):
                return
        raise RuntimeError("engine did not drain")
