"""paged_flash_roofline: the paged decode attention kernel's share of its
roofline (bytes of the valid K/V rows and queries read, outputs written,
free slots one row each), with the split decode's combine launches in
its time.  Moves serve_tokens_per_s."""
from perfbench import lib


def read(ctx):
    return lib.roofline(ctx, "paged_flash", also=("combine",))
