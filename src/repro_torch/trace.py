"""Phase marks, spans and counters for timing a training step or a
serving dispatch on the card.

The simulation engine and :func:`repro_torch.optim.decentralized.mix`
call :func:`mark` at the phase boundaries of a step:

    "step"    a step begins (gradients come next)
    "update"  the gradients are done; the method's update begins
    "mix"     a gossip mix begins
    "end"     the step is done

A failure-model step (``simulate_decentralized(failure=)``) marks the
same, and its mixer closure marks each tensor's ``"stale"`` read (the
history ring), ``"corrupt"`` read (the Byzantine values) and ``"mix"``;
``"state"`` opens the node freeze, the clocks and the history write
after the method's update.

The distributed train step (``repro_torch.dist.steps``) marks
``"step"``, ``"update"`` and ``"end"`` the same way; in place of
``"mix"``, its gossip mixer marks each tensor's exchange and each
bucket's combine (compressed: each bucket's ``"quantize"``, then its
reference leaves' ``"exchange"`` (the point-to-point messages), then its
``"combine"``).

The continuous serving engine marks each dispatch with its name
(``"prefill_<bucket>"``, ``"prefill_<bucket>x<n>"``, ``"decode"``) and
then ``"end"``.  The fixed-batch engine marks each speculative round's
phases: ``"round"`` (the window snapshot), ``"draft"``, ``"verify"``,
``"accept"`` (the accept rule and the restore), then ``"end"``.

Outside :func:`cuda_marks` a mark is one global lookup and does
nothing.  Inside it, each mark records a CUDA event on the current
stream, so the spans between marks are device time with no extra
synchronisation; read them after the block, once the work has finished.

**Spans.**  Inside the same block, ``with span(name, id):`` records a
:class:`Span`: its host start and end in ns on ``time.time_ns()``, the
clock of ``torch.profiler``'s event timestamps; the index of the span
open around it; whether a torch profiler was running when it opened;
with ``device=True``, which the caller passes where the span's work runs
on a card, its device ms from a pair of CUDA events; and the change of
every counter between its ends.  Counters are running totals of the
block: :func:`count` adds to one, and a span with ``allocs=True`` (again
only where the work runs on a card) reads the CUDA caching allocator just
before its start clock and just after its end clock, adding the
allocator's device calls (``num_device_alloc + num_device_free``) to
``"alloc.device"`` and its retries to ``"alloc.retries"``.  After the
block, :func:`last` returns the block's spans in the order they opened.
The port opens these:

    "step"          one iteration of ``ContinuousEngine.run``'s loop
                    (id: the step index)
    "prefill"       ``ContinuousEngine._prefill``, through the host's
                    read of the first tokens (id: the request ids;
                    allocs)
    "decode"        the decode dispatch, after its mark, through the
                    host's read of the tokens (id: the step index)
    "decode.prep"   inside "decode": the host builds the block table,
                    the last tokens and the positions and copies them
                    to the card, which has nothing queued (id: the step)
    "decode.launch" ``ContinuousEngine._decode``: from the model's first
                    launch to the sampler's return (id: each slot's
                    request id; allocs).  Not launches alone: the host
                    also waits inside it wherever the model copies from
                    the host to the card (each attention layer's rope
                    copies its theta, a stream sync)
    "moe.experts"   ``MoE.forward``'s gathered expert products and gate
                    scaling (device)

Outside the block, :func:`span` returns one shared no-op context and
:func:`count` returns at once, each after one global lookup.
"""
from __future__ import annotations

import contextlib
import time

import torch

_marks: list | None = None
_rec: "_Recording | None" = None
_last: list = []


def mark(name: str) -> None:
    if _marks is not None:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        _marks.append((name, event))


class _Recording:
    """The spans and counter totals of one :func:`cuda_marks` block."""

    def __init__(self):
        self.spans: list[Span] = []
        self.open: list[int] = []        # indices of the open spans
        self.totals: dict[str, int] = {}
        self.allocator = None

    def count(self, name: str, n: int) -> None:
        self.totals[name] = self.totals.get(name, 0) + n

    def read_allocator(self) -> None:
        """Count the allocator's calls since the last reading (the first
        reading only sets the base; none before CUDA is initialised)."""
        stats = torch.cuda.memory_stats_as_nested_dict()
        if not stats:
            return
        now = (stats.get("num_device_alloc", 0)
               + stats.get("num_device_free", 0),
               stats.get("num_alloc_retries", 0))
        if self.allocator is not None:
            self.count("alloc.device", now[0] - self.allocator[0])
            self.count("alloc.retries", now[1] - self.allocator[1])
        self.allocator = now


class Span:
    """One span of a recording.  ``parent`` is the index of the span
    open around it (None at the top), ``device_ms`` is None until
    :func:`last` reads its events, and stays None without
    ``device=True``; ``counters`` holds each counter's change between its
    ends."""

    __slots__ = ("name", "id", "parent", "start_ns", "end_ns", "device_ms",
                 "profiled", "counters", "_rec", "_device", "_allocs",
                 "_start", "_end", "_opened")

    def __init__(self, rec: _Recording, name: str, id=None, *,
                 device: bool = False, allocs: bool = False):
        self.name, self.id = name, id
        self.parent = None
        self.start_ns = self.end_ns = 0
        self.device_ms = None
        self.profiled = False
        self.counters: dict[str, int] = {}
        self._rec, self._device, self._allocs = rec, device, allocs
        self._start = self._end = None        # CUDA events
        self._opened: dict[str, int] = {}

    def __enter__(self):
        rec = self._rec
        if self._allocs:
            rec.read_allocator()
        self.parent = rec.open[-1] if rec.open else None
        self.profiled = torch.autograd._profiler_enabled()
        self._opened = dict(rec.totals)
        rec.open.append(len(rec.spans))
        rec.spans.append(self)
        self.start_ns = time.time_ns()
        if self._device:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if self._start is not None:
            self._end = torch.cuda.Event(enable_timing=True)
            self._end.record()
        self.end_ns = time.time_ns()
        if self._allocs:
            rec.read_allocator()
        self.counters = {k: v - self._opened.get(k, 0)
                         for k, v in rec.totals.items()}
        rec.open.pop()
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str, id=None, *, device: bool = False, allocs: bool = False):
    """A span named ``name`` inside :func:`cuda_marks`; outside it, the
    shared no-op context."""
    rec = _rec
    if rec is None:
        return _NO_SPAN
    return Span(rec, name, id, device=device, allocs=allocs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` inside :func:`cuda_marks`."""
    rec = _rec
    if rec is not None:
        rec.count(name, n)


def last() -> list[Span]:
    """The spans of the last :func:`cuda_marks` block that ended, their
    device ms read (waiting for the events' work where it is not done)."""
    for s in _last:
        if s._end is not None:
            s._end.synchronize()
            s.device_ms = s._start.elapsed_time(s._end)
            s._start = s._end = None
    return _last


@contextlib.contextmanager
def cuda_marks():
    """Record a CUDA event at every :func:`mark` inside the block, and the
    block's spans and counters; yields the list of ``(name, event)``
    pairs, in order."""
    global _marks, _rec, _last
    if _marks is not None:
        raise RuntimeError("cuda_marks blocks do not nest")
    _marks = []
    _rec = _Recording()
    try:
        yield _marks
    finally:
        _last = _rec.spans
        _marks = _rec = None
