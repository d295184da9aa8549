"""Sampling layer of the decode engine (port of
``repro/serve/sampling.py``).

:class:`SamplingParams`, :func:`modified_logits`, :func:`sampling_probs`
and :func:`speculative_accept` are the reference's.  Randomness comes
from ``torch.Generator`` s on the engine's device:

* the fixed-batch engine keeps one per request slot, seeded from
  ``(seed, slot)`` (:func:`request_generators`);
* the continuous engine seeds one per draw from ``(seed, request id,
  absolute position, stream tag)`` (:func:`stream_generator`), as the
  reference folds its keys, so a request's draws depend neither on its
  slot, nor on its batch, nor on the acceptance history.

The streams differ from the reference's ``jax.random`` ones: sampled runs
are checked by their laws, greedy runs token for token.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

_MODES = ("greedy", "sample")
_NEG_INF = -1e30
_MASK64 = (1 << 64) - 1

# stream tags of the per-position draws: the speculative round's three
# (the reference's, ``sampling.py:38``) and the plain token draw
DRAFT_STREAM, ACCEPT_STREAM, CORRECTION_STREAM, TOKEN_STREAM = 0, 1, 2, 3


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


def _mix64(z: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit ints that spreads
    every input bit over the output."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def stream_generator(seed: int, rid: int, position: int, stream: int,
                     device) -> torch.Generator:
    """The generator of one draw of request ``rid`` at absolute
    ``position`` in stream ``stream`` (the reference's ``fold_pos_keys``,
    ``sampling.py:85-101``), seeded from the hash of the four ints."""
    h = 0
    for v in (seed, rid, position, stream):
        h = _mix64(h ^ (int(v) & _MASK64))
    g = torch.Generator(device=device)
    g.manual_seed(h)
    return g


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


def sampling_probs(logits, params: SamplingParams) -> torch.Tensor:
    """Probabilities of the modified distribution (f32)."""
    return torch.softmax(modified_logits(logits, params), dim=-1)


def sample_token(logits, params: SamplingParams,
                 generators=None) -> torch.Tensor:
    """logits: (B, V) -> (B,) int64 token ids.  ``generators``: one per
    row, required in sample mode."""
    if params.mode == "greedy":
        return logits.argmax(dim=-1)
    probs = sampling_probs(logits, params)
    return torch.cat([torch.multinomial(probs[b], 1, generator=g)
                      for b, g in enumerate(generators)])


def speculative_accept(verify_logits, draft_logits, draft_tokens,
                       params: SamplingParams, streams=None,
                       positions=None):
    """Draft-k-verify-once accept/reject (``sampling.py:124-205``).

    verify_logits: (B, k+1, V) target logits of the verify window (row i
    is the target distribution of emitted token i); draft_logits:
    (B, k, V) the distributions that proposed ``draft_tokens`` (B, k).

    Greedy: the accepted count is the leading run of exact argmax
    matches, and the next token the target argmax after it.  Sample: the
    residual rule — draft i is accepted iff ``u_i * q_i(d_i) <=
    p_i(d_i)``; at the first rejection the token is drawn from
    ``normalize(max(p - q, 0))``, and after k acceptances from ``p_k``
    (q padded with zeros).  ``streams``: per row ``(seed, request id)``;
    ``positions``: (B,) ints, the absolute position of emitted token 0.
    The uniforms and the correction draw come from
    :func:`stream_generator` at each emitted position.

    Returns ``(accept, tokens)``: accept (B,) int64 in [0, k], tokens
    (B, k+1) — the accepted drafts, then the correction/bonus token in
    column ``accept`` (later columns are padding)."""
    B, kp1, V = verify_logits.shape
    k = kp1 - 1
    dev = verify_logits.device
    vl = verify_logits.float()
    if params.mode == "greedy":
        t_hat = vl.argmax(dim=-1)                                # (B, k+1)
        match = (draft_tokens == t_hat[:, :k]).long()
        accept = match.cumprod(dim=1).sum(dim=1)
        corr = t_hat.gather(1, accept[:, None])[:, 0]
    else:
        p = sampling_probs(vl, params)                           # (B, k+1, V)
        q = sampling_probs(draft_logits.float(), params)
        p_d = p[:, :k].gather(-1, draft_tokens[..., None])[..., 0]
        q_d = q.gather(-1, draft_tokens[..., None])[..., 0]
        u = torch.stack([torch.stack([torch.rand(
            (), device=dev, generator=stream_generator(
                seed, rid, int(pos) + j, ACCEPT_STREAM, dev))
            for j in range(k)]) for (seed, rid), pos in zip(streams,
                                                              positions)])
        ok = (u * q_d <= p_d).long()
        accept = ok.cumprod(dim=1).sum(dim=1)
        q_pad = torch.cat([q, torch.zeros_like(q[:, :1])], dim=1)
        at = accept[:, None, None].expand(B, 1, V)
        p_at = p.gather(1, at)[:, 0]
        r = (p_at - q_pad.gather(1, at)[:, 0]).clamp_min(0.0)
        den = r.sum(dim=-1, keepdim=True)
        # a degenerate residual (q covers p exactly in f32) falls back to
        # the target distribution itself
        r = torch.where(den > 0.0, r / den.clamp_min(1e-30), p_at)
        acc = accept.tolist()
        corr = torch.cat([torch.multinomial(r[b], 1, generator=(
            stream_generator(seed, rid, int(pos) + acc[b],
                             CORRECTION_STREAM, dev)))
            for b, ((seed, rid), pos) in enumerate(zip(streams,
                                                         positions))])
    d_pad = torch.cat([draft_tokens, torch.zeros_like(draft_tokens[:, :1])],
                      dim=1)
    cols = torch.arange(kp1, device=dev)
    tokens = torch.where(cols[None, :] < accept[:, None], d_pad,
                         corr[:, None])
    return accept, tokens
