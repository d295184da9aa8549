"""flash_roofline.train: the flash attention forward kernel's share of
its roofline in training (encoder, causal decoder self-attention and
cross-attention launches; operations from the shapes, causal counting
half the score matrix), over its device time.  Moves
train_tokens_per_s."""
from perfbench import lib


def read(ctx):
    return lib.roofline(ctx, "flash")
