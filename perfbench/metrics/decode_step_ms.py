"""decode_step_ms: device ms of one lockstep decode dispatch (marks
"decode" -> "end"), the mean over the window's.  Moves tpot_ms_p95."""


def read(ctx):
    spans = [ms for name, ms in ctx["marks"] if name == "decode"]
    return sum(spans) / len(spans) if spans else None
