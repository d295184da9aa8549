"""moe_experts_ms.prefill: device ms of the MoE layers' expert products in
one prefill dispatch (the port's spans "moe.experts", one a layer, timed
by CUDA events), summed over the dispatch's layers; the mean over the
window's prefill dispatches outside the profiled slice (a mean, as
prefill_ms, over the traffic's mix of buckets).  Nothing where the port
records no spans.  Moves ttft_ms_p95."""
from repro_torch import trace


def read(ctx):
    spans = getattr(trace, "last", list)()
    per: dict[int, float] = {}
    for s in spans:
        if s.name == "moe.experts" and s.device_ms is not None \
                and s.parent is not None \
                and spans[s.parent].name == "prefill" \
                and not spans[s.parent].profiled:
            per[s.parent] = per.get(s.parent, 0.0) + s.device_ms
    return sum(per.values()) / len(per) if per else None
