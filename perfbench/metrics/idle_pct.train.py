"""idle_pct.train: the share of a training step in which no operation runs
on the card: one less the device-busy seconds a step in the profiled
slice (the union of the trace's device activity) over the wall seconds a
step in the rest of the window.  Every step of a training cell does the
same work (the same shapes, kernels and launches), so the slice's busy
time a step is that of any step; its wall time is not used, because the
profiler slows the host several times over.  Not clamped: a busy time
above the wall time reads below nought and shows a count at fault.
Moves train_tokens_per_s."""


def read(ctx):
    return 100.0 * (1.0 - ctx["busy_per_step_s"] / ctx["wall_per_step_s"])
