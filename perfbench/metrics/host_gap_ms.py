"""host_gap_ms: host ms of one continuous-engine step in which the card
has no work queued: the self time of the port's span "step" (its
duration less that of its "prefill" and "decode" spans: admission and
retirement) plus its "decode.prep" spans (inside "decode": the block
table, last tokens and positions built and copied to the card), the
median over the steps that dispatched something, outside the profiled
slice (a step any of whose spans opened under the profiler is left out,
so the profiler's start and stop are too).  Nothing where the port
records no spans.  Moves serve_tokens_per_s."""
import statistics

from repro_torch import trace


def read(ctx):
    spans = getattr(trace, "last", list)()
    kids: dict[int, list] = {}
    for i, s in enumerate(spans):
        if s.parent is not None:
            kids.setdefault(s.parent, []).append(i)
    gaps = []
    for i, s in enumerate(spans):
        if s.name != "step" or s.profiled:
            continue
        inner = [spans[k] for k in kids.get(i, [])]
        work = [c for c in inner if c.name in ("prefill", "decode")]
        if not work or any(c.profiled for c in inner):
            continue
        prep = [spans[k] for j in kids.get(i, [])
                if spans[j].name == "decode" for k in kids.get(j, [])
                if spans[k].name == "decode.prep"]
        busy = sum(c.end_ns - c.start_ns for c in work) \
            - sum(p.end_ns - p.start_ns for p in prep)
        gaps.append((s.end_ns - s.start_ns - busy) / 1e6)
    return statistics.median(gaps) if gaps else None
