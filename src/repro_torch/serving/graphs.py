"""CUDA graphs of the serving engine's decode dispatches: the port's
counterpart of the reference's jitted decode (one XLA call a dispatch) and
of its ``lax.scan`` over K fused micro-steps.

A ``DecodeGraphs`` keeps one captured graph per key for one owner (a
``FleetGroup``'s slab, a ``ReplicaEngine``'s pool). ``run(key, fn)`` is one
dispatch: ``fn`` enqueues the decode on the current stream, reading and
writing only tensors whose addresses stay put while the graphs live (the
owner's serve state, its device operands, its static operand buffers, the
weights), and returns a tuple of its small outputs.

  * On a CUDA device the first dispatch of a key runs ``fn`` eagerly on a
    side stream -- the dispatch's real work, and the warm-up a capture
    needs -- and then captures ``fn`` into a graph (capture records the
    launches without running them). Every later dispatch of the key
    replays the graph on the current stream and returns its static
    outputs, which the next replay of any graph of the owner overwrites:
    the caller copies them out on the same stream before it dispatches
    again (``engine._Pending``). A failed capture or replay raises;
    nothing decodes eagerly in a graph's place.
  * On the CPU, or with ``eager=True`` (the eager oracle), ``fn`` runs
    eagerly every time. The keys, the counts and the drop rule are the same
    on the CPU, so the CPU tests exercise the bookkeeping.

A fleet group's row block over several ``model`` devices
(``engine._Shard``) captures its steps only when those devices are one
device (a mesh that repeats one card); across cards a step crosses
devices inside each layer, and its ``DecodeGraphs`` is made ``eager``.
The mesh decides it, never a failed capture.

``drop()`` forgets every graph: the owner calls it when its state or
operand tensors are reallocated (a slab growth), never when they change in
place (a backfill on remove, an admission, a chunk, a staged mask). The
slots held out of decode while they stream a chunked prefill are such a
mask: the masked variant's write index leaves them out, restaged into the
same buffer each round, so a new set of held rows replays the same graph.
An int8 pool's four leaves are state like a float pool's two.

**Launch counts.** ``ops.LAUNCHES`` counts in the wrappers, on the host, so
a replay would add nothing and a capture would add launches that did not
run. A capture's additions are taken back and kept as the graph's own
count; each replay adds them.

All of an owner's live graphs share one memory pool (a new one after each
``drop``: PyTorch refuses to capture into a pool whose graphs are all
gone while it still holds memory). Sharing is safe because the replays
are serialized on one stream and each graph's outputs are copied out
before the next replay (PyTorch's rule for a shared pool). The warm-up and
the capture run on one side stream a device (``_capture_stream``), so
the cuBLAS workspace of the stream they capture on is made by the warm-up
and never inside a graph's pool. Replays and eager launches run on the
current stream, and the side stream is ordered against it both ways:
``flash_decode``'s ticket counters (``kernels.decode_attention.tickets``,
one buffer a device) are never used by two launches at once. A capture
synchronizes the device (``torch.cuda.graph`` does), once a key.
"""
from __future__ import annotations

import gc

import torch

from repro_torch import telemetry
from repro_torch.kernels import ops

_streams: dict = {}          # device -> the warm-up and capture stream


def _capture_stream(device: torch.device):
    if device not in _streams:
        _streams[device] = torch.cuda.Stream(device)
    return _streams[device]


class _Graph:
    """A captured dispatch: ``replay()`` runs it and returns its outputs;
    each replay adds ``launches`` to ``ops.LAUNCHES``."""
    __slots__ = ("replay", "launches")

    def __init__(self, replay, launches: dict):
        self.replay = replay
        self.launches = launches


class DecodeGraphs:
    """The captured decode graphs of one owner (see the module docstring).
    ``captures`` counts graphs captured, ``recaptures`` those that replace
    a graph of the same key dropped by ``drop()``, ``replays`` the
    dispatches served by a replay."""

    def __init__(self, device: torch.device, eager: bool = False):
        self.device = device
        self.eager = eager
        self.capture = device.type == "cuda" and not eager
        self.pool = torch.cuda.graph_pool_handle() if self.capture else None
        self._graphs: dict = {}
        self._dropped: set = set()
        self.captures = self.recaptures = self.replays = 0

    def drop(self) -> None:
        """Forget every graph (the owner's tensors were reallocated)."""
        self._dropped.update(self._graphs)
        self._graphs.clear()
        if self.pool is not None:
            self.pool = torch.cuda.graph_pool_handle()

    def stats(self) -> dict:
        return {"captures": self.captures, "recaptures": self.recaptures,
                "replays": self.replays}

    def run(self, key, fn) -> tuple:
        """One dispatch of ``fn`` under ``key``: its outputs."""
        if self.eager:
            return fn()
        g = self._graphs.get(key)
        if g is not None:
            self.replays += 1
            with telemetry.span("graphs.replay"):
                out = g.replay()
            for k, n in g.launches.items():
                ops.LAUNCHES[k] += n
            return out
        with telemetry.span("graphs.capture"):
            out = self._warm(fn)
            self._graphs[key] = self._record(fn)
        self.captures += 1
        if key in self._dropped:
            self._dropped.discard(key)
            self.recaptures += 1
        return out

    def _warm(self, fn) -> tuple:
        """The key's first dispatch, eager: on a card, on a side stream
        ordered after and before the current one."""
        if not self.capture:
            return fn()
        cur = torch.cuda.current_stream(self.device)
        side = _capture_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn()
        cur.wait_stream(side)
        return out

    def _record(self, fn) -> _Graph:
        """Capture ``fn``, taking the capture's launch counts back into the
        graph's own; on the CPU, keep ``fn`` to run eagerly."""
        if not self.capture:
            return _Graph(fn, {})
        before = dict(ops.LAUNCHES)
        replay = self._capture(fn)
        launches = {k: ops.LAUNCHES[k] - before[k] for k in before}
        ops.LAUNCHES.update(before)
        return _Graph(replay, launches)

    def _capture(self, fn):
        """A replay of ``fn`` captured into a CUDA graph in the pool: it
        runs the graph and returns the static outputs. Python's cyclic
        garbage collector is off during the capture: a collection there
        can free an unreachable owner's graphs, and destroying a graph is
        a CUDA call that invalidates the capture (seen on the card as a
        failed cuBLAS call inside the capture)."""
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool,
                                  stream=_capture_stream(self.device)):
                outs = fn()
        finally:
            if collecting:
                gc.enable()

        def replay():
            graph.replay()
            return outs
        return replay

    def pool_bytes(self) -> int:
        """Device bytes the graphs' pool holds (0 without graphs)."""
        if self.pool is None:
            return 0
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == tuple(self.pool))
