"""The program's spans and counters: one registry of host seconds and
counts, and, while ``torch.profiler`` records, the same spans on the
profiler's timeline beside the kernels.

    with telemetry.span("engine.decode_round"):
        ...
    @telemetry.spanned("engine.reconcile")    # every call of a method
    def reconcile(self): ...
    telemetry.count("engine.prefill_tokens", n)
    telemetry.session()    # the totals of the last profiler session

``span(name, into=None)`` always adds its elapsed ``time.perf_counter()``
seconds and a count of 1 to the registry under ``name``. Only while the
profiler records does it also open ``torch.profiler.record_function(name)``,
so a profiled run's trace names each stretch of host work by the innermost
span open over it. With the profiler off it calls no ``record_function``
(that costs ~15 us a call on a CPU host even when nothing records); it
reads one module flag, ``torch.autograd.profiler._is_profiler_enabled``.
``into=(obj, attr)`` or ``(dict, key)`` also adds the span's seconds
there: the owner's own counters (``ControlPlane.host_s``, ``fetch_wait``,
an engine's ``sync_wait``) take the same measurement.

A span without ``into`` is one object a name, entered again at each call
(it keeps a stack, so it may nest in itself): a span off the profiler
makes no new object. ``spanned(name)`` puts a whole function or
method inside one.

``count(name, n)`` adds ``n`` to a counter of the registry.
``count_on_device(name, n, device)`` adds ``n`` (a tensor the device
computed, or a whole number) to a counter that lives on ``device``, in
place and without a host sync: a decode step captured in a CUDA graph
counts again at every replay. Only ``session()`` reads such a counter,
after the profiler has stopped; a session's bounds take an on-device copy
of it, so nothing in a tick waits for the device.

**Sessions.** A session starts at the first span or count that finds the
profiler recording after a time when it was not, and ends at the first
that finds it off again (else when ``session()`` is read); the registry
snapshots its cumulative totals at both points, and ``session()`` gives
their difference. A profiler started and stopped between two ticks of the
control loop thus gives a session whose ``plane.step`` count is the
number of ticks it covered; a profiler session that runs no program code
opens none. The registry is process-wide, as the profiler is; the control
loop runs in one thread.
"""
from __future__ import annotations

import functools
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _prof
from torch.autograd.profiler import record_function

_clock = time.perf_counter


class Session(NamedTuple):
    """The last profiler session: ``spans`` {name: (seconds, count)} and
    ``counters`` {name: total}, each the change over the session."""
    spans: dict
    counters: dict


class _Registry:
    def __init__(self):
        self.spans: dict = {}        # name -> [seconds, count], cumulative
        self.counters: dict = {}     # name -> total, cumulative
        self.device: dict = {}       # (name, device) -> 0-d int64 tensor
        self.recording = False       # the profiler recorded at the last poll
        self.start = self.end = None  # (spans, counters) snapshots
        self.dstart = self.dend = None  # device counters' copies

    def snapshot(self) -> tuple:
        return ({k: tuple(v) for k, v in self.spans.items()},
                dict(self.counters))

    def device_snapshot(self) -> dict:
        """On-device copies of the device counters: no host sync."""
        return {k: t.clone() for k, t in self.device.items()}

    def poll(self) -> bool:
        """Whether the profiler records; opens or closes a session where
        that changed since the last poll."""
        on = _prof._is_profiler_enabled
        if on != self.recording:
            self.recording = on
            if on:
                self.start, self.end = self.snapshot(), None
                self.dstart, self.dend = self.device_snapshot(), None
            else:
                self.end = self.snapshot()
                self.dend = self.device_snapshot()
        return on


_REG = _Registry()


class _Span:
    """A timed region (see the module docstring); a context manager that
    may be entered again while open (its own stack of entries)."""
    __slots__ = ("name", "into", "entry", "open")

    def __init__(self, name: str, into=None):
        self.name = name
        self.into = into
        self.entry = _REG.spans.setdefault(name, [0.0, 0])
        self.open: list = []     # (record_function or None, start) pairs

    def __enter__(self):
        rf = None
        if _prof._is_profiler_enabled or _REG.recording:
            if _REG.poll():
                rf = record_function(self.name)
                rf.__enter__()
        o = self.open
        o.append(rf)
        o.append(_clock())
        return self

    def __exit__(self, et, ev, tb):
        o = self.open
        dt = _clock() - o.pop()
        rf = o.pop()
        if rf is not None:
            rf.__exit__(et, ev, tb)
        e = self.entry
        e[0] += dt
        e[1] += 1
        if self.into is not None:
            owner, key = self.into
            if type(owner) is dict:
                owner[key] += dt
            else:
                setattr(owner, key, getattr(owner, key) + dt)
        return False


_plain: dict = {}      # name -> the _Span of every call without into


def span(name: str, into=None) -> _Span:
    """The span ``name`` (see the module docstring). Without ``into`` one
    object serves every call of a name, so a span costs no allocation."""
    if into is None:
        s = _plain.get(name)
        if s is None:
            s = _plain[name] = _Span(name)
        return s
    return _Span(name, into)


def spanned(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""
    s = span(name)

    def wrap(fn):
        @functools.wraps(fn)
        def call(*a, **kw):
            with s:
                return fn(*a, **kw)
        return call
    return wrap


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name``."""
    _REG.poll()
    _REG.counters[name] = _REG.counters.get(name, 0) + n


def count_on_device(name: str, n, device) -> None:
    """Add ``n`` (an integer tensor on ``device``, or a whole number) to the
    device counter ``name`` on ``device``, in place (see the module
    docstring). The counter is made at its first use, which must come
    outside a CUDA graph capture (a graph's first dispatch runs eagerly,
    ``serving.graphs``)."""
    dev = torch.device(device)
    key = (name, dev)
    capturing = dev.type == "cuda" and torch.cuda.is_current_stream_capturing()
    if not capturing:
        _REG.poll()
    acc = _REG.device.get(key)
    if acc is None:
        if capturing:
            raise RuntimeError(f"device counter {name!r} first used inside "
                               "a CUDA graph capture")
        acc = _REG.device[key] = torch.zeros((), dtype=torch.int64,
                                             device=dev)
    acc.add_(n)


def session() -> Session:
    """The change of every span and counter over the last profiler session
    (up to now if the profiler still records), device counters summed over
    their devices and read here; empty if none ran."""
    if not _prof._is_profiler_enabled:
        _REG.poll()              # stopped with no span since: close it now
    if _REG.start is None:
        return Session({}, {})
    s0, c0 = _REG.start
    s1, c1 = _REG.end if _REG.end is not None else _REG.snapshot()
    spans = {}
    for k, (sec, n) in s1.items():
        a, m = s0.get(k, (0.0, 0))
        if n > m:
            spans[k] = (sec - a, n - m)
    counters = {k: v - c0.get(k, 0) for k, v in c1.items()
                if v != c0.get(k, 0)}
    d0 = _REG.dstart or {}
    d1 = _REG.dend if _REG.dend is not None else _REG.device
    for key, t in d1.items():
        n = int(t) - (int(d0[key]) if key in d0 else 0)
        if n:
            counters[key[0]] = counters.get(key[0], 0) + n
    return Session(spans, counters)
