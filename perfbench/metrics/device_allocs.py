"""device_allocs: calls the CUDA caching allocator makes to the device
(cudaMalloc and cudaFree, which synchronises) inside the continuous
engine's dispatches, per 1000 dispatches: the port's counter
"alloc.device" over its spans "prefill" and "decode.launch", outside the
profiled slice.  0 in a steady state.  Nothing where the port records no
such counter.  Moves ttft_ms_p95."""
from repro_torch import trace


def read(ctx):
    spans = getattr(trace, "last", list)()
    calls = [s.counters["alloc.device"] for s in spans
             if s.name in ("prefill", "decode.launch") and not s.profiled
             and "alloc.device" in s.counters]
    return 1000.0 * sum(calls) / len(calls) if calls else None
