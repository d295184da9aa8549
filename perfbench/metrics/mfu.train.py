"""mfu.train: the whole training step's share of the card's bf16 peak:
the useful operations of the window's steps (forward and backward of
every node, ``arith.train_step_flops``) over window x 989 TFLOP/s.
Moves train_tokens_per_s."""
from perfbench import lib


def read(ctx):
    if not ctx.get("flops_per_step") or not ctx.get("steps"):
        return None
    return 100.0 * ctx["flops_per_step"] * ctx["steps"] \
        / (ctx["window_s"] * lib.PEAK_FLOPS_BF16)
