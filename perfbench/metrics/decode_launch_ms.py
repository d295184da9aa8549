"""decode_launch_ms: host ms of the continuous engine's decode call (the
port's span "decode.launch": from the model's first launch to the
sampler's return), the median over the window's decode dispatches outside
the profiled slice.  Not the host's enqueueing alone: the span holds the
stream syncs of the model's copies from the host (each attention layer's
rope copies its theta), so the host waits there for the card's work
queued before them; near decode_step_ms it does not show the decode
host-bound.  Nothing where the port records no spans.  Moves
tpot_ms_p95."""
import statistics

from repro_torch import trace


def read(ctx):
    spans = getattr(trace, "last", list)()
    ms = [(s.end_ns - s.start_ns) / 1e6 for s in spans
          if s.name == "decode.launch" and not s.profiled]
    return statistics.median(ms) if ms else None
