"""flash_roofline.serve: the flash attention kernel's share of its
roofline in bucketed prefill (operations of the bucket's causal square,
half the score matrix), over its device time.  Moves
serve_tokens_per_s."""
from perfbench import lib


def read(ctx):
    return lib.roofline(ctx, "flash")
