"""mfu.serve: the serving run's share of the card's bf16 peak: the useful
operations of every prompt token prefilled and every token decoded
(routed experts at top-k, not the capacity's slots; padding and free
slots not counted) over window x 989 TFLOP/s.  Moves
serve_tokens_per_s."""
from perfbench import lib


def read(ctx):
    if not ctx.get("flops"):
        return None
    return 100.0 * ctx["flops"] / (ctx["window_s"] * lib.PEAK_FLOPS_BF16)
