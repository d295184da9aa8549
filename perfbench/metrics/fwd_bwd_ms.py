"""fwd_bwd_ms: device ms a training step spends in the nodes' forward
and backward passes (the port's marks "step" -> "update"), over the
window's steps.  Moves train_tokens_per_s."""


def read(ctx):
    spans = [ms for name, ms in ctx["marks"] if name == "step"]
    return sum(spans) / len(spans) if spans else None
