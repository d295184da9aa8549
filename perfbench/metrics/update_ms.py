"""update_ms: device ms a training step spends in the method's update
(marks "update" -> "mix"), over the window's steps.  Moves
train_tokens_per_s."""


def read(ctx):
    spans = [ms for name, ms in ctx["marks"] if name == "update"]
    return sum(spans) / len(spans) if spans else None
