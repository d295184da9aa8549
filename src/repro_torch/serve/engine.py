"""Fixed-batch decode engine (port of ``repro/serve/engine.py``).

The reference compiles the whole generation phase into one ``lax.scan``.
PyTorch runs eagerly, so here the engine is a prefill followed by a
Python loop of ``decode_step`` + ``sample_token`` under
``torch.inference_mode()``.  With an ``eos_id``, finished rows are frozen
by the done-mask (they emit ``eos_id``) and the loop stops once every row
is done, as the reference's ``lax.cond`` early exit does.
``dispatch_counter[0]`` counts generations, one per ``generate`` call.

``speculate_k > 0`` turns on draft-k-verify-once speculative decoding
(DESIGN.md Sec. 15).  Each round of the loop:

* snapshots the cache rows ``[pos, pos + k]`` of every request (``pos``
  its next write position), every per-position leaf of every layer
  (dense K/V, or MLA's ``ckv`` / ``krope`` latent), before anything is
  drafted;
* drafts k tokens, one position per step at the (B,) positions: through
  the first ``draft_layers`` pattern blocks of the target itself
  (self-speculative, default ``num_blocks // 2``), or through a separate
  ``draft_cfg`` model with its own cache, which then takes one more,
  write-only, step for the last draft's K/V;
* verifies all k + 1 rows in ONE ``decode_step`` at the (B,) positions
  (the dense flash kernel's per-request ``q_start`` path,
  ``ops.sdpa_decode``);
* accepts by :func:`~repro_torch.serve.sampling.speculative_accept`, clips
  each request by its eos and its budget, and restores the window rows
  past what it kept from the snapshot, in the target cache and in a
  draft cache: rejected drafts leave both bit for bit as if nothing was
  drafted.

Greedy speculative tokens equal the plain engine's.  A request stops
taking rounds once it is done or full, and the loop stops when every
request has.  Sampled draws of a speculative engine come from generators
seeded by ``(seed, row, absolute position, stream)``
(:func:`~repro_torch.serve.sampling.stream_generator`), as the
continuous engine's; the plain engine keeps one generator per row.  Each
round's phases are bracketed by :func:`repro_torch.trace.mark`:
``"round"`` (the snapshot), ``"draft"``, ``"verify"``, ``"accept"`` (the
accept rule, the restore and the counters), then ``"end"``.

``mesh=`` serves on one rank of a live ``(data, model)`` mesh
(``launch.mesh``): prefill and the plain decode steps go through
``dist.steps.make_prefill`` / ``make_decode_step``, ``generate`` takes
this rank's shard dict (``convert.shard_for_rank``; or the model
``dist.tp.bind`` made of it) and its rows of the batch
(``dist.steps.local_rows``), and returns the tokens of those rows.  Each
row keeps its own seeded sampling streams, the global row's, so a row
draws what it draws on one rank.  After each token (a speculative round's
emitted tokens) the ranks that hold the same rows compare what they
picked, over each mesh axis that does not split the batch, and the engine
raises if they differ.  Self-speculation runs unchanged through the
sharded layers.  A ``draft_cfg`` model is bound to this rank's shards
under the same serve rules (``dist.tp.bind``), and its prefill, cache
and decode steps run through its sharded layers, as the reference's
``dpre`` and ``dcsh`` (``engine.py:443-453``); ``generate`` then takes
the draft's shard dict (or its bound model) as ``draft_params``.  The
draft's rules must give this rank the target's rows.

``prefix_len`` counts the positions a vision model's ``prefix_embeds``
take in front of the prompt (``engine.py:194-244``): generation starts at
``index0 = prompt_len + prefix_len``, and the cache covers ``index0 +
max_new + speculate_k`` positions.  An encoder-decoder's batch carries
``frames``; prefill keeps the encoder output in the caches, where every
decode step reads it.  Speculation takes a prefix self-speculatively
only, and no encoder model, as the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple

import torch

from repro_torch import trace
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.blocks import layer_caches

from .sampling import (DRAFT_STREAM, TOKEN_STREAM, SamplingParams,
                       request_generators, sample_token, speculative_accept,
                       stream_generator)


def decode_logits_scan(cfg, params, caches, tokens, index0, *,
                       decode_mode="dus", block_table=None):
    """Teacher-forced decode (``engine.py:50-72``): feed ``tokens[:, t]``
    at position ``index0 + t`` and return the per-step logits (B, T, V)
    and the caches, updated in place.  ``index0`` is an int, or a (B,)
    tensor of per-request start positions (dense or, with
    ``decode_mode="paged"`` and ``block_table``, paged)."""
    out = []
    with torch.inference_mode():
        for t in range(tokens.shape[1]):
            lg, caches = M.decode_step(cfg, params, caches,
                                       tokens[:, t:t + 1], index0 + t,
                                       decode_mode=decode_mode,
                                       block_table=block_table)
            out.append(lg[:, 0])
    return torch.stack(out, dim=1), caches


class SpecStats(NamedTuple):
    """Per-request speculative counters, (B,) int64 each.  A round is one
    draft-k + verify-once pass; ``accepted / drafted`` is the acceptance
    rate and ``rounds / lengths`` the verify passes per emitted token."""
    rounds: Any
    drafted: Any
    accepted: Any


class GenerationResult(NamedTuple):
    """``tokens`` (B, max_new) int64; ``done`` (B,) bool; ``caches`` the
    KV caches filled through the last decoded position; ``lengths`` (B,)
    generated counts including the terminating eos; ``spec`` the
    :class:`SpecStats` of a speculative engine (None on plain ones)."""
    tokens: Any
    done: Any
    caches: Any
    lengths: Any
    spec: Any = None


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
    speculate_k: int = 0
    draft_layers: int | None = None
    draft_cfg: Any = None
    prefix_len: int = 0
    dispatch_counter: list = field(default_factory=lambda: [0])
    # with a mesh: the sharding rules, this rank's steps, its first row
    # and row count, and the axes whose ranks hold the same rows
    mesh: Any = None
    rules: Any = None
    prefill: Any = None
    decode: Any = None
    row0: int = 0
    rows: int | None = None
    replica_axes: tuple = ()

    @property
    def index0(self) -> int:
        """The position of the first generated token: after the prefix
        embeddings and the prompt."""
        return self.prompt_len + self.prefix_len

    @property
    def seq(self) -> int:
        """Cache length: the prefix, the prompt, every generated position
        and ``speculate_k`` rows of headroom for the last verify window."""
        return self.index0 + self.max_new + self.speculate_k

    def generate(self, params, batch, seed: int = 0, *, draft_params=None):
        """Prefill ``batch`` then generate ``max_new`` tokens.  Returns
        ``(tokens, done)``."""
        r = self.generate_with_state(params, batch, seed,
                                     draft_params=draft_params)
        return r.tokens, r.done

    def generate_with_state(self, params, batch, seed: int = 0, *,
                            draft_params=None) -> GenerationResult:
        """Like :meth:`generate`, and also returns the final caches and
        the per-request lengths.  ``batch`` holds ``tokens``, and
        ``prefix_embeds`` (B, prefix_len, d_model) or ``frames`` where the
        model takes them.  ``draft_params`` are required iff the engine
        has a ``draft_cfg``; the draft's caches are dropped."""
        tokens = batch["tokens"]
        want = (self.rows, self.prompt_len)
        if tuple(tokens.shape) != want or tokens.device != self.device:
            raise ValueError(f"tokens must be {want} on {self.device}, got "
                             f"{tuple(tokens.shape)} on {tokens.device}")
        prefix = batch.get("prefix_embeds")
        got = None if prefix is None else tuple(prefix.shape)
        if (0 if got is None else got[1]) != self.prefix_len:
            raise ValueError(f"the engine takes {self.prefix_len} prefix "
                             f"positions, got prefix_embeds of shape {got}")
        inputs = {k: batch[k] for k in ("tokens", "prefix_embeds", "frames")
                  if batch.get(k) is not None}
        if self.mesh is not None:
            from repro_torch.dist.steps import bound_model
            params = bound_model(self.cfg, self.mesh, params)
            if self.draft_cfg is not None and draft_params is not None:
                draft_params = bound_model(self.draft_cfg, self.mesh,
                                           draft_params)
        for p in (params, draft_params):
            if p is not None and p.embed.table.dtype != self.param_dtype:
                raise TypeError(f"engine built for {self.param_dtype} "
                                f"params, got {p.embed.table.dtype}")
        if self.speculate_k and self.draft_cfg is not None \
                and draft_params is None:
            raise ValueError("this engine speculates through a draft_cfg; "
                             "pass draft_params")
        self.dispatch_counter[0] += 1
        enc = None
        with torch.inference_mode():
            if self.mesh is None:
                logits, caches = M.prefill(self.cfg, params, inputs,
                                           self.seq, self.cache_dtype)
            else:
                logits, caches, enc = self.prefill.fn(params, inputs)
            spec = None
            if self.speculate_k:
                dcaches = None
                if self.draft_cfg is not None:
                    _, dcaches = M.prefill(self.draft_cfg, draft_params,
                                           {"tokens": tokens}, self.seq,
                                           self.cache_dtype)
                out, done, spec = self._speculate(params, logits, caches,
                                                  seed, draft_params,
                                                  dcaches)
            else:
                out, done = self._decode(params, logits, caches, seed, enc)
            eos, B = self.eos_id, self.rows
            if eos is None:
                lengths = torch.full((B,), self.max_new, dtype=torch.int64,
                                     device=self.device)
            else:
                hit = out == eos
                lengths = torch.where(hit.any(dim=1),
                                      hit.int().argmax(dim=1) + 1,
                                      self.max_new)
        return GenerationResult(tokens=out, done=done, caches=caches,
                                lengths=lengths, spec=spec)

    def _first(self, logits, gens):
        """The first token from the prompt's last logits, the done-mask
        and the (B, max_new) output holding it (eos-padded)."""
        eos, B = self.eos_id, self.rows
        tok = sample_token(logits[:, -1].float(), self.sampling, gens)
        done = (tok == eos) if eos is not None else torch.zeros(
            B, dtype=torch.bool, device=self.device)
        out = torch.full((B, self.max_new), 0 if eos is None else eos,
                         dtype=torch.int64, device=self.device)
        out[:, 0] = tok
        return tok, done, out

    def _agree(self, params, tok):
        """With a mesh: raise unless every rank that holds this rank's
        rows picked the same ``tok``."""
        for axis in self.replica_axes:
            picks = params.tp.gather(tok, axis)
            if not all(torch.equal(p, tok) for p in picks):
                raise RuntimeError(
                    f"the ranks along {axis!r} picked different tokens for "
                    f"the same rows: {[p.tolist() for p in picks]}")

    def _decode(self, params, logits, caches, seed, enc=None):
        """The plain loop: one decode step per token (with a mesh, this
        rank's ``make_decode_step``; ``enc`` is the encoder output its
        prefill returned)."""
        cfg, eos = self.cfg, self.eos_id
        gens = (request_generators(seed, self.batch, self.device)
                [self.row0:self.row0 + self.rows]
                if self.sampling.needs_rng else None)
        tok, done, out = self._first(logits, gens)
        self._agree(params, tok)
        for i in range(1, self.max_new):
            if eos is not None and bool(done.all()):
                break           # the remaining columns already hold eos
            if self.decode is None:
                logits, caches = M.decode_step(cfg, params, caches,
                                               tok[:, None],
                                               self.index0 + i - 1)
            else:
                logits, caches = self.decode.fn(
                    params, caches, tok[:, None], self.index0 + i - 1,
                    *(() if enc is None else (enc,)))
            nxt = sample_token(logits[:, -1].float(), self.sampling, gens)
            self._agree(params, nxt)
            if eos is not None:
                nxt = torch.where(done, eos, nxt)
                done = done | (nxt == eos)
            out[:, i] = nxt
            tok = nxt
        return out, done

    def _streams(self, seed, positions, stream):
        """One generator per row at its absolute position, or None when
        greedy."""
        if not self.sampling.needs_rng:
            return None
        return [stream_generator(seed, self.row0 + b, p, stream, self.device)
                for b, p in enumerate(positions)]

    def _speculate(self, params, logits, caches, seed, draft_params,
                   dcaches):
        """The speculative loop (``_spec_generate``, ``engine.py:335-441``):
        returns ``(tokens, done, SpecStats)``; the caches are updated in
        place."""
        cfg, dcfg, eos = self.cfg, self.draft_cfg, self.eos_id
        k, B, N, dev = self.speculate_k, self.rows, self.max_new, self.device
        ar = torch.arange(k + 1, device=dev)
        tok, done, out = self._first(
            logits, self._streams(seed, [self.index0] * B, TOKEN_STREAM))
        self._agree(params, tok)
        # one spare column takes the writes of what a round does not keep
        buf = torch.cat([out, out[:, :1]], dim=1)
        rows = torch.arange(B, device=dev)[:, None]
        n = torch.ones(B, dtype=torch.int64, device=dev)   # tokens so far
        rounds = torch.zeros(B, dtype=torch.int64, device=dev)
        accepted = torch.zeros_like(rounds)
        # every layer cache a round writes: the target's, and the draft's
        layers = list(layer_caches(caches)) + (
            [] if dcfg is None else list(layer_caches(dcaches)))
        while True:
            live = ~done & (n < N)
            if not bool(live.any()):
                break
            trace.mark("round")
            pos = self.index0 + n - 1                      # next write
            win = pos[:, None] + ar                        # (B, k+1)
            # every per-position leaf: dense K/V, or MLA's latent rows
            saved = [{c: lc[c][rows, win] for c in lc} for lc in layers]
            # host positions, read only by the sampled draws
            hpos = pos.tolist() if self.sampling.needs_rng else [0] * B
            trace.mark("draft")
            cur, dlg, dtk = tok, [], []
            for i in range(k):
                if dcfg is None:
                    lg, _ = M.decode_step(cfg, params, caches, cur[:, None],
                                          pos + i,
                                          draft_layers=self.draft_layers)
                else:
                    lg, _ = M.decode_step(dcfg, draft_params, dcaches,
                                          cur[:, None], pos + i)
                lg = lg[:, -1].float()
                cur = sample_token(lg, self.sampling, self._streams(
                    seed, [p + 1 + i for p in hpos], DRAFT_STREAM))
                dlg.append(lg)
                dtk.append(cur)
            if dcfg is not None:
                # write-only: the last draft's K/V, so the next round's
                # draft never reads a stale row, even when all k pass
                M.decode_step(dcfg, draft_params, dcaches, cur[:, None],
                              pos + k)
            dtk = torch.stack(dtk, dim=1)                  # (B, k)
            trace.mark("verify")
            vlg, _ = M.decode_step(cfg, params, caches,
                                   torch.cat([tok[:, None], dtk], dim=1),
                                   pos)
            trace.mark("accept")
            acc, emit = speculative_accept(
                vlg, torch.stack(dlg, dim=1), dtk, self.sampling,
                [(seed, self.row0 + b) for b in range(B)],
                [p + 1 for p in hpos])
            m = acc + 1                                    # emitted count
            if eos is not None:
                hit = emit == eos
                first = torch.where(hit.any(dim=1),
                                    hit.int().argmax(dim=1), k + 1)
                m = torch.minimum(m, first + 1)
            m = torch.where(live, torch.minimum(m, N - n), 0)
            keep = ar[None, :] < m[:, None]                # (B, k+1)
            buf[rows, torch.where(keep, n[:, None] + ar, N)] = emit
            for lc, s in zip(layers, saved):
                for c in lc:
                    now = lc[c][rows, win]
                    mask = keep.reshape(keep.shape + (1,) * (now.ndim - 2))
                    lc[c][rows, win] = torch.where(mask, now, s[c])
            self._agree(params, emit)
            last = emit.gather(1, (m - 1).clamp_min(0)[:, None])[:, 0]
            tok = torch.where(live, last, tok)
            if eos is not None:
                done = done | (hit & keep).any(dim=1)
            rounds += live.long()
            accepted += torch.where(live, acc, 0)
            n = n + m
            trace.mark("end")
        return buf[:, :N], done, SpecStats(rounds=rounds,
                                           drafted=rounds * k,
                                           accepted=accepted)


def _check_spec_family(cfg, role: str) -> None:
    """Speculation rolls back per-position cache rows: every layer must be
    attention (dense K/V or MLA's latent, both rolled back row by row)
    with no cross-attention, and there is no encoder
    (``engine.py:175-193``)."""
    if cfg.encoder is not None:
        raise NotImplementedError(
            f"speculative decoding does not cover encoder-decoder "
            f"{role} models")
    for spec in tuple(cfg.prologue) + tuple(cfg.pattern):
        if spec.kind != "attn" or spec.cross_attn:
            raise NotImplementedError(
                f"speculative decoding needs attn-family layers with "
                f"per-position cache rows; {role} config has "
                f"kind={spec.kind!r} cross_attn={spec.cross_attn}")


def make_engine(cfg, *, batch: int, prompt_len: int, max_new: int,
                sampling: SamplingParams = SamplingParams(),
                eos_id: int | None = None, prefix_len: int = 0,
                param_dtype=torch.bfloat16, cache_dtype=torch.bfloat16,
                speculate_k: int = 0, draft_layers: int | None = None,
                draft_cfg=None, device=None, mesh=None) -> GenerationBundle:
    """The generation engine for one serving shape.  ``prefix_len``
    counts the non-token prefix positions (a vision model's
    ``prefix_embeds``).  The KV cache covers ``prompt_len + prefix_len +
    max_new + speculate_k`` positions; prefill attends over all of it
    with the empty tail masked, as the reference does.

    ``speculate_k > 0`` speculates (see the module docstring):
    self-speculatively through the first ``draft_layers`` pattern blocks
    (default ``num_blocks // 2``, at least 1), or through a separate
    ``draft_cfg`` of the same vocabulary, whose params ``generate`` then
    takes as ``draft_params``.  Without ``speculate_k`` both are
    ignored, as in the reference (``engine.py:218-241``).

    ``mesh`` (a live mesh, ``launch.mesh``) serves on this rank of it
    (see the module docstring); ``batch`` is then the whole batch, of
    which the engine takes this rank's rows, and a ``draft_cfg`` model
    is served over the same mesh."""
    if batch < 1 or prompt_len < 1 or max_new < 1 or prefix_len < 0:
        raise ValueError(f"batch, prompt_len and max_new must be >= 1 and "
                         f"prefix_len >= 0, got {batch}, {prompt_len}, "
                         f"{max_new}, {prefix_len}")
    if speculate_k < 0:
        raise ValueError(f"speculate_k must be >= 0, got {speculate_k}")
    if speculate_k:
        _check_spec_family(cfg, "target")
        if draft_cfg is not None:
            if draft_layers is not None:
                raise ValueError("pass draft_layers (self-speculative) OR "
                                 "draft_cfg (separate draft), not both")
            _check_spec_family(draft_cfg, "draft")
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab_size} != target vocab "
                    f"{cfg.vocab_size}")
            if prefix_len:
                raise NotImplementedError(
                    "draft_cfg speculation does not cover prefix embeddings"
                    " (the draft frontend differs); use self-speculative")
        else:
            if draft_layers is None:
                draft_layers = max(1, cfg.num_blocks // 2)
            if not 0 <= draft_layers <= cfg.num_blocks:
                raise ValueError(
                    f"draft_layers must be in [0, {cfg.num_blocks}], got "
                    f"{draft_layers}")
    else:
        draft_layers = draft_cfg = None
    sharded = {"rows": batch}
    if mesh is not None:
        from repro_torch.dist.sharding import make_rules
        from repro_torch.dist.steps import (local_rows, make_decode_step,
                                            make_prefill)
        seq = prompt_len + prefix_len + max_new + speculate_k
        kw = dict(batch=batch, seq=seq, param_dtype=param_dtype)
        pre = make_prefill(cfg, mesh, cache_dtype=cache_dtype, **kw)
        rules = pre.rules
        row0, rows = local_rows(rules, batch)
        split = rows < batch
        sharded = dict(
            mesh=mesh, rules=rules, prefill=pre,
            decode=make_decode_step(cfg, mesh, **kw), row0=row0, rows=rows,
            replica_axes=tuple(a for a in mesh.axis_names
                               if mesh.shape[a] > 1
                               and not (split and a in rules.dp)))
        if draft_cfg is not None:
            drows = local_rows(make_rules(mesh, arch_name=draft_cfg.name,
                                          context="serve"), batch)
            if drows != (row0, rows):
                raise ValueError(
                    f"the draft {draft_cfg.name}'s serve rules give this "
                    f"rank rows {drows}, the target's {(row0, rows)}")
    return GenerationBundle(cfg=cfg, batch=batch, prompt_len=prompt_len,
                            max_new=max_new, sampling=sampling,
                            eos_id=eos_id, param_dtype=param_dtype,
                            cache_dtype=cache_dtype,
                            device=resolve_device(device),
                            speculate_k=speculate_k,
                            draft_layers=draft_layers, draft_cfg=draft_cfg,
                            prefix_len=prefix_len, **sharded)
