"""Fixed-batch decode engine (port of ``repro/serve/engine.py``).

The reference compiles the whole generation phase into one ``lax.scan``.
PyTorch runs eagerly, so here the engine is a prefill followed by a
Python loop of ``decode_step`` + ``sample_token`` under
``torch.inference_mode()``.  With an ``eos_id``, finished rows are frozen
by the done-mask (they emit ``eos_id``) and the loop stops once every row
is done, as the reference's ``lax.cond`` early exit does.
``dispatch_counter[0]`` counts generations, one per ``generate`` call.

The fixed-batch engine's speculative mode (``speculate_k``, ``draft_cfg``)
is not ported yet; the continuous engine (:mod:`.continuous`) speculates.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import model as M

from .sampling import SamplingParams, request_generators, sample_token


class GenerationResult(NamedTuple):
    """``tokens`` (B, max_new) int64; ``done`` (B,) bool; ``caches`` the
    KV caches filled through the last decoded position; ``lengths`` (B,)
    generated counts including the terminating eos."""
    tokens: Any
    done: Any
    caches: Any
    lengths: Any


@dataclass(frozen=True)
class GenerationBundle:
    cfg: Any
    batch: int
    prompt_len: int
    max_new: int
    sampling: SamplingParams
    eos_id: int | None
    param_dtype: torch.dtype
    cache_dtype: torch.dtype
    device: torch.device
    dispatch_counter: list = field(default_factory=lambda: [0])

    @property
    def seq(self) -> int:
        """Cache length: the prompt plus every generated position."""
        return self.prompt_len + self.max_new

    def generate(self, params, batch, seed: int = 0):
        """Prefill ``batch`` then generate ``max_new`` tokens.  Returns
        ``(tokens, done)``."""
        r = self.generate_with_state(params, batch, seed)
        return r.tokens, r.done

    def generate_with_state(self, params, batch,
                            seed: int = 0) -> GenerationResult:
        tokens = batch["tokens"]
        want = (self.batch, self.prompt_len)
        if tuple(tokens.shape) != want or tokens.device != self.device:
            raise ValueError(f"tokens must be {want} on {self.device}, got "
                             f"{tuple(tokens.shape)} on {tokens.device}")
        if params.embed.table.dtype != self.param_dtype:
            raise TypeError(f"engine built for {self.param_dtype} params, "
                            f"got {params.embed.table.dtype}")
        cfg, eos, B = self.cfg, self.eos_id, self.batch
        self.dispatch_counter[0] += 1
        with torch.inference_mode():
            logits, caches = M.prefill(cfg, params, {"tokens": tokens},
                                       self.seq, self.cache_dtype)
            gens = (request_generators(seed, B, self.device)
                    if self.sampling.needs_rng else None)
            tok = sample_token(logits[:, -1].float(), self.sampling, gens)
            done = (tok == eos) if eos is not None else torch.zeros(
                B, dtype=torch.bool, device=self.device)
            out = torch.full((B, self.max_new), 0 if eos is None else eos,
                             dtype=torch.int64, device=self.device)
            out[:, 0] = tok
            for i in range(1, self.max_new):
                if eos is not None and bool(done.all()):
                    break       # the remaining columns already hold eos
                logits, caches = M.decode_step(cfg, params, caches,
                                               tok[:, None],
                                               self.prompt_len + i - 1)
                nxt = sample_token(logits[:, -1].float(), self.sampling,
                                   gens)
                if eos is not None:
                    nxt = torch.where(done, eos, nxt)
                    done = done | (nxt == eos)
                out[:, i] = nxt
                tok = nxt
            if eos is None:
                lengths = torch.full((B,), self.max_new, dtype=torch.int64,
                                     device=self.device)
            else:
                hit = out == eos
                lengths = torch.where(hit.any(dim=1),
                                      hit.int().argmax(dim=1) + 1,
                                      self.max_new)
        return GenerationResult(tokens=out, done=done, caches=caches,
                                lengths=lengths)


def make_engine(cfg, *, batch: int, prompt_len: int, max_new: int,
                sampling: SamplingParams = SamplingParams(),
                eos_id: int | None = None, param_dtype=torch.bfloat16,
                cache_dtype=torch.bfloat16, device=None) -> GenerationBundle:
    """The generation engine for one serving shape.  The KV cache covers
    ``prompt_len + max_new`` positions; prefill attends over all of it
    with the empty tail masked, as the reference does."""
    if batch < 1 or prompt_len < 1 or max_new < 1:
        raise ValueError(f"batch, prompt_len and max_new must be >= 1, got "
                         f"{batch}, {prompt_len}, {max_new}")
    return GenerationBundle(cfg=cfg, batch=batch, prompt_len=prompt_len,
                            max_new=max_new, sampling=sampling,
                            eos_id=eos_id, param_dtype=param_dtype,
                            cache_dtype=cache_dtype,
                            device=resolve_device(device))
