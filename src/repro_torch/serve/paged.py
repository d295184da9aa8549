"""Host-side bookkeeping for the paged serve engine (the port's copy of
``repro/serve/paged.py``, DESIGN.md Sec. 14).

The device-side paged layout lives in :mod:`repro_torch.models.model`
(``PagedCacheLayout``, ``init_paged_cache``) and
:func:`repro_torch.kernels.ops.paged_sdpa`.  This module holds what the
continuous scheduler needs on the host:

* :class:`PagePool`, the physical-page free list.  Page 0 is reserved as
  the scratch page: free slots point their whole block-table row at it,
  so the garbage K/V their lockstep decode writes lands where no live
  request reads.
* prompt buckets (:func:`prompt_buckets` / :func:`bucket_for`): prompts
  are right-padded to power-of-two lengths.
* :func:`poisson_trace`, the seeded ragged-arrival workload, the
  reference's trace element for element for the same arguments.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


class PagePool:
    """Free list over physical pages ``1 .. num_pages-1``.

    Page 0 is the reserved scratch page (never handed out); allocation is
    lowest-index-first, so runs are reproducible given the same admission
    order."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved scratch)")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))  # pop() -> lowest

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int]:
        """Take ``n`` pages; raises if the pool cannot cover them (the
        scheduler checks ``available`` first and defers admission)."""
        if n > len(self._free):
            raise RuntimeError(f"page pool exhausted: want {n}, "
                               f"have {len(self._free)}")
        return [self._free.pop() for _ in range(n)]

    def free(self, pages) -> None:
        for p in pages:
            if not 0 < p < self.num_pages:
                raise ValueError(f"freeing invalid page {p}")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
            self._free.append(p)
        self._free.sort(reverse=True)


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


@dataclass(frozen=True)
class Request:
    """One queued generation request.  ``arrival`` is in virtual time
    (decode-step units): the scheduler admits a request once the step
    counter reaches it."""
    rid: int
    tokens: tuple  # prompt token ids
    arrival: float = 0.0

    @property
    def prompt_len(self) -> int:
        return len(self.tokens)


def poisson_trace(num_requests: int, *, rate: float, seed: int,
                  min_prompt: int = 4, max_prompt: int = 48,
                  vocab_size: int = 256) -> list[Request]:
    """Seeded ragged workload: exponential inter-arrival gaps at ``rate``
    requests per decode step, prompt lengths uniform on ``[min_prompt,
    max_prompt]``, token ids uniform on the vocab.  The same (seed,
    parameters) give the same trace, the reference's included."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    rng = np.random.RandomState(seed)
    t = 0.0
    out = []
    for rid in range(num_requests):
        t += float(rng.exponential(1.0 / rate))
        n = int(rng.randint(min_prompt, max_prompt + 1))
        toks = tuple(int(x) for x in rng.randint(0, vocab_size, size=n))
        out.append(Request(rid=rid, tokens=toks, arrival=t))
    return out
