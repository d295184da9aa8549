"""Sampling layer of the decode engine (port of
``repro/serve/sampling.py``).

:class:`SamplingParams` and :func:`modified_logits` are the reference's.
Randomness comes from one ``torch.Generator`` per request slot, seeded
from ``(seed, slot)`` on the engine's device, so a slot's draws depend
only on its seed, its slot and its own logits — never on its batch
neighbours.  The streams differ from the reference's ``jax.random`` ones:
sampled runs are checked by their laws, greedy runs token for token.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

_MODES = ("greedy", "sample")
_NEG_INF = -1e30


@dataclass(frozen=True)
class SamplingParams:
    """Sampling policy.

    ``mode``: ``greedy`` (argmax; temperature/top_k/top_p ignored) or
    ``sample`` (softmax sampling at ``temperature``, optionally truncated
    to the ``top_k`` most likely tokens and/or the ``top_p`` nucleus — the
    smallest set whose cumulative probability reaches ``top_p``).  top_k
    truncates first; the nucleus is taken over the survivors."""
    mode: str = "greedy"
    temperature: float = 1.0
    top_k: int | None = None
    top_p: float | None = None

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got "
                             f"{self.mode!r}")
        if self.mode == "sample" and not self.temperature > 0.0:
            raise ValueError("sample mode needs temperature > 0 "
                             "(use mode='greedy' for argmax decoding)")
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if self.top_p is not None and not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def needs_rng(self) -> bool:
        return self.mode == "sample"


def request_generators(seed: int, batch: int, device) -> list:
    """One generator per request slot, seeded from ``(seed, slot)``."""
    gens = []
    for slot in range(batch):
        g = torch.Generator(device=device)
        g.manual_seed(((seed & 0xFFFFFFFF) << 32) | slot)
        gens.append(g)
    return gens


def modified_logits(logits, params: SamplingParams) -> torch.Tensor:
    """f32 logits after temperature / top-k / top-p; masked-out tokens
    sit at -1e30."""
    l = logits.float() / params.temperature
    if params.top_k is not None and params.top_k < l.shape[-1]:
        kth = torch.topk(l, params.top_k, dim=-1).values[..., -1:]
        l = torch.where(l < kth, _NEG_INF, l)
    if params.top_p is not None and params.top_p < 1.0:
        # keep every token whose EXCLUSIVE descending prefix mass is still
        # below top_p; ties at the threshold are all kept
        p = torch.softmax(l, dim=-1)
        sp = torch.sort(p, dim=-1, descending=True).values
        keep = (torch.cumsum(sp, dim=-1) - sp) < params.top_p
        thr = torch.where(keep, sp, torch.inf).amin(dim=-1, keepdim=True)
        l = torch.where(p >= thr, l, _NEG_INF)
    return l


def sample_token(logits, params: SamplingParams,
                 generators=None) -> torch.Tensor:
    """logits: (B, V) -> (B,) int64 token ids.  ``generators``: one per
    row, required in sample mode."""
    if params.mode == "greedy":
        return logits.argmax(dim=-1)
    probs = torch.softmax(modified_logits(logits, params), dim=-1)
    return torch.cat([torch.multinomial(probs[b], 1, generator=g)
                      for b, g in enumerate(generators)])
