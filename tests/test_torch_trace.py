"""The port's tracing (``repro_torch.trace``): spans and counters inside
:func:`cuda_marks`, nothing outside it, the marks as they were, the
profiler's clock, the serving engine's and the MoE layer's spans, and
the benchmark's readers of them.  The work runs on the CPU, where a span
takes no CUDA events and reads no allocator; where a test asks for them,
stand-ins take the place of the card's, so the tests read the same with
a card and without."""
from __future__ import annotations

import time

import pytest
import torch

from perfbench import lib
from repro_torch import trace
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models.moe import MoE
from repro_torch.serve import ContinuousEngine, PagedCacheLayout
from repro_torch.serve.paged import Request


class _Event:
    """A stand-in for ``torch.cuda.Event``: the marks and spans record it,
    and any two are 1.5 ms apart."""

    def __init__(self, enable_timing=False):
        self.recorded = 0

    def record(self):
        self.recorded += 1

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1.5


@pytest.fixture
def events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)


def test_spans_nest_with_parents_ids_times_and_counters(events, monkeypatch):
    reads = []

    def stats():                 # the allocator's totals at each reading
        reads.append(None)
        n = len(reads)
        return {"num_device_alloc": 3 * n, "num_device_free": n,
                "num_alloc_retries": n // 2}

    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", stats)
    with trace.cuda_marks():
        trace.count("x", 7)                       # before any span
        with trace.span("a", 1):
            trace.count("x", 2)
            with trace.span("b", [3, 4]):
                trace.count("x", 3)
                trace.count("y")
            with trace.span("c"):
                pass
        with trace.span("d", device=True, allocs=True):
            trace.count("y", 5)
    a, b, c, d = spans = trace.last()
    assert [s.name for s in spans] == ["a", "b", "c", "d"]
    assert [s.parent for s in spans] == [None, 0, 0, None]
    assert [s.id for s in spans] == [1, [3, 4], None, None]
    assert a.start_ns <= b.start_ns <= b.end_ns <= c.start_ns <= c.end_ns \
        <= a.end_ns <= d.start_ns <= d.end_ns
    assert abs(a.start_ns - time.time_ns()) < 60e9
    assert a.counters == {"x": 5, "y": 1}
    assert b.counters == {"x": 3, "y": 1}
    assert c.counters == {"x": 0, "y": 0}
    # the allocator read at d's two ends: 4 + 4 calls, then 1 retry
    assert d.counters == {"x": 0, "y": 5, "alloc.device": 4,
                          "alloc.retries": 1}
    assert len(reads) == 2
    assert [s.device_ms for s in spans] == [None, None, None, 1.5]
    assert not any(s.profiled for s in spans)


def test_outside_the_block_nothing_is_recorded():
    with trace.cuda_marks():
        with trace.span("kept"):
            pass
    kept = trace.last()
    off = trace.span("step", 3, device=True, allocs=True)
    assert off is trace.span("decode") is trace._NO_SPAN
    with off as opened:
        assert opened is None
        assert trace.count("x", 2) is None
    assert trace.last() is kept and [s.name for s in kept] == ["kept"]
    with trace.cuda_marks():
        with pytest.raises(RuntimeError, match="do not nest"):
            with trace.cuda_marks():
                pass
    assert trace.last() == []


def test_a_span_brackets_the_profilers_event_on_its_clock():
    a = torch.randn(64, 64)
    with trace.cuda_marks():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with trace.span("mm"):
                torch.mm(a, a)
        with trace.span("after"):
            pass
    mm, after = trace.last()
    assert mm.profiled and not after.profiled
    got = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mm"]
    assert len(got) == 1
    assert mm.start_ns <= got[0][0] <= got[0][1] <= mm.end_ns


def _engine_run(arch, *, n, **kw):
    cfg = get_config(arch).reduced()
    params = M.init(cfg, seed=0, device="cpu")
    eng = ContinuousEngine(cfg, slots=2, layout=PagedCacheLayout(
        page_size=4, num_pages=9, max_pages_per_slot=4), max_new=3,
        buckets=(4, 8), device="cpu", **kw)
    reqs = [Request(rid=10 + i, tokens=tuple(range(1, 3 + 2 * i)),
                    arrival=0.5 * i) for i in range(n)]
    return cfg, params, eng, eng.run(params, reqs, seed=1)


def test_spans_leave_the_marks_as_they_were(events, monkeypatch):
    """The flat marks of a run, as yielded and as a caller that replaces
    ``trace.mark`` on the module sees them, are the dispatches' names,
    each then "end", the same with spans recorded and with none."""
    seen = []
    orig = trace.mark

    def watch(name):
        seen.append(name)
        orig(name)

    monkeypatch.setattr(trace, "mark", watch)
    with trace.cuda_marks() as marks:
        *_, eng, res = _engine_run("gemma3-1b", n=3)
    assert trace.last()
    names = [name for name, _ in marks]
    assert all(isinstance(e, _Event) and e.recorded == 1 for _, e in marks)
    assert names == seen and names[1::2] == ["end"] * (len(names) // 2)
    assert sorted(names[::2]) == sorted(
        k for k, v in res["stats"]["dispatches"].items() for _ in range(v))
    seen.clear()
    monkeypatch.setattr(trace, "span", lambda *a, **k: trace._NO_SPAN)
    with trace.cuda_marks() as bare:
        *_, res2 = _engine_run("gemma3-1b", n=3)
    assert trace.last() == []
    assert [name for name, _ in bare] == names == seen
    assert {r: v.tokens for r, v in res2["results"].items()} \
        == {r: v.tokens for r, v in res["results"].items()}


def test_moe_engine_spans(events):
    """A reduced grok-1-314b served continuously: one "step" span a loop
    iteration, a "decode" and under it one "decode.prep" and then one
    "decode.launch" a decode dispatch, one "prefill" a request, and one
    "moe.experts" per MoE layer under each prefill and each decode
    launch.  The work runs on the CPU: no span times the device or reads
    the allocator."""
    with trace.cuda_marks():
        cfg, params, eng, res = _engine_run("grok-1-314b", n=3)
    spans = trace.last()
    layers = sum(isinstance(m, MoE) for m in params.modules())
    assert layers == cfg.num_layers >= 2
    by = {}
    for i, s in enumerate(spans):
        by.setdefault(s.name, []).append(i)
    assert set(by) == {"step", "prefill", "decode", "decode.prep",
                       "decode.launch", "moe.experts"}
    assert [spans[i].id for i in by["step"]] == \
        list(range(res["stats"]["steps"]))
    assert all(spans[i].parent is None for i in by["step"])
    assert len(by["decode.launch"]) == len(by["decode.prep"]) \
        == len(by["decode"]) == res["stats"]["dispatches"]["decode"]
    for i, j in zip(by["decode.prep"], by["decode.launch"]):
        assert spans[i].parent == spans[j].parent and i < j
        assert spans[i].end_ns <= spans[j].start_ns
        assert spans[i].id == spans[spans[i].parent].id
    for i in by["decode"]:
        assert spans[spans[i].parent].name == "step"
        assert spans[i].id == spans[spans[i].parent].id
    for i in by["decode.launch"]:
        assert spans[spans[i].parent].name == "decode"
        assert len(spans[i].id) == eng.slots
    assert sorted(rid for i in by["prefill"] for rid in spans[i].id) \
        == sorted(res["results"])
    assert all(spans[spans[i].parent].name == "step" for i in by["prefill"])
    per = {}
    for i in by["moe.experts"]:
        per[spans[i].parent] = per.get(spans[i].parent, 0) + 1
        assert spans[i].device_ms is None
    assert per == {i: layers for i in by["prefill"] + by["decode.launch"]}
    assert all(s.counters == {} for s in spans)


def _synthetic():
    """Three steps outside the profiler and two at its edges: step 0
    prefills and decodes, steps 1 and 2 decode, step 3 starts the profiler
    in its decode, step 4 runs under it (times in ms; each decode copies
    its arguments for 0.5 ms, then launches)."""
    rec = trace._Recording()
    out = []

    def mk(name, parent, t0, t1, id=None, device_ms=None, profiled=False,
           allocs=None):
        s = trace.Span(rec, name, id)
        s.parent, s.start_ns, s.end_ns = parent, int(t0 * 1e6), int(t1 * 1e6)
        s.device_ms, s.profiled = device_ms, profiled
        if allocs is not None:
            s.counters = {"alloc.device": allocs, "alloc.retries": 0}
        out.append(s)
        return len(out) - 1

    def decode(step, t0, launch_ms, experts, allocs=0, profiled=False,
               step_profiled=None):
        st = mk("step", None, t0, t0 + 10 + launch_ms, id=step,
                profiled=profiled if step_profiled is None else step_profiled)
        dec = mk("decode", st, t0 + 1, t0 + 9 + launch_ms, id=step,
                 profiled=profiled)
        mk("decode.prep", dec, t0 + 1, t0 + 1.5, id=step, profiled=profiled)
        dl = mk("decode.launch", dec, t0 + 1.5, t0 + 1.5 + launch_ms,
                profiled=profiled, allocs=allocs)
        for ms in experts:
            mk("moe.experts", dl, t0 + 1.5, t0 + 2, device_ms=ms,
               profiled=profiled)
        return st

    st = decode(0, 0.0, 2.0, [1.0, 2.0], allocs=4)
    pre = mk("prefill", st, 0.2, 0.8, id=[7], allocs=2)
    for ms in (5.0, 6.0):
        mk("moe.experts", pre, 0.3, 0.4, device_ms=ms)
    pre = mk("prefill", st, 0.8, 0.9, id=[8], allocs=0)
    mk("moe.experts", pre, 0.85, 0.86, device_ms=3.0)
    decode(1, 20.0, 3.0, [2.0, 2.5])
    decode(2, 40.0, 5.0, [3.0, 4.0])
    decode(3, 60.0, 9.0, [9.0, 9.0], allocs=50, profiled=True,
           step_profiled=False)
    decode(4, 90.0, 9.0, [9.0, 9.0], allocs=50, profiled=True)
    mk("step", None, 120.0, 120.01, id=5)        # an idle step
    return out


@pytest.mark.parametrize("metric,want", [
    ("decode_launch_ms", 3.0),          # launches of 2, 3, 5 ms
    # steps 0-2: 12 - 10.7 in dispatches, 13 - 11, 15 - 13, each + 0.5
    # copying the decode's arguments
    ("host_gap_ms", 2.5),
    ("moe_experts_ms.decode", 4.5),     # 3.0, 4.5, 7.0
    ("moe_experts_ms.prefill", 7.0),    # (11 + 3) / 2
    ("device_allocs", 1200.0),          # 6 calls in 5 dispatches
])
def test_readers_of_the_spans(metric, want, monkeypatch):
    reader = lib.load_module("metrics", f"{metric}.py")
    monkeypatch.setattr(trace, "_last", _synthetic())
    assert reader.read({}) == pytest.approx(want)
    monkeypatch.setattr(trace, "_last", [])
    assert reader.read({}) is None
    monkeypatch.delattr(trace, "last")           # a port without spans
    assert reader.read({}) is None
