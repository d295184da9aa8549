"""mix_ms: device ms a training step spends in the gossip mix (marks
"mix" -> "end"), over the window's steps outside the profiled slice.
Moves train_tokens_per_s."""


def read(ctx):
    spans = [ms for name, ms in ctx["marks"] if name == "mix"]
    return sum(spans) / len(spans) if spans else None
