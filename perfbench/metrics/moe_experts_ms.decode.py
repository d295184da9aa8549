"""moe_experts_ms.decode: device ms of the MoE layers' expert products in
one decode dispatch (the port's spans "moe.experts", one a layer: the
gather, the three batched products and the gate scaling, timed by CUDA
events), summed over the dispatch's layers; the median over the window's
decode dispatches ("decode.launch") outside the profiled slice.  Nothing
where the port records no spans.  Moves tpot_ms_p95."""
import statistics

from repro_torch import trace


def read(ctx):
    spans = getattr(trace, "last", list)()
    per: dict[int, float] = {}
    for s in spans:
        if s.name == "moe.experts" and s.device_ms is not None \
                and s.parent is not None \
                and spans[s.parent].name == "decode.launch" \
                and not spans[s.parent].profiled:
            per[s.parent] = per.get(s.parent, 0.0) + s.device_ms
    return statistics.median(per.values()) if per else None
