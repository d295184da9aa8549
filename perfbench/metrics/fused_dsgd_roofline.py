"""fused_dsgd_roofline: the fused DSGD update kernel's share of its
roofline: the bytes of its inputs and outputs at the HBM rate, over its
device time in the profiler's trace.  Moves train_tokens_per_s."""
from perfbench import lib


def read(ctx):
    return lib.roofline(ctx, "fused_dsgd")
