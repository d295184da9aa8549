"""Prompt-length buckets (the port's copy of ``serve/paged.py:65-89``)."""
from __future__ import annotations


def prompt_buckets(max_prompt: int, *, min_bucket: int = 8) -> tuple[int, ...]:
    """Power-of-two bucket lengths covering prompts up to ``max_prompt``."""
    if max_prompt < 1:
        raise ValueError(f"max_prompt must be >= 1, got {max_prompt}")
    buckets = []
    b = min_bucket
    while True:
        buckets.append(b)
        if b >= max_prompt:
            return tuple(buckets)
        b *= 2


def bucket_for(prompt_len: int, buckets) -> int:
    """Smallest bucket holding ``prompt_len`` tokens."""
    for b in buckets:
        if prompt_len <= b:
            return b
    raise ValueError(f"prompt_len {prompt_len} exceeds the largest bucket "
                     f"{buckets[-1]}")
