"""prefill_ms: device ms of one prefill dispatch (marks "prefill_*" ->
"end"; one request each), the mean over the window's.  Moves
ttft_ms_p95."""


def read(ctx):
    spans = [ms for name, ms in ctx["marks"] if name.startswith("prefill_")]
    return sum(spans) / len(spans) if spans else None
