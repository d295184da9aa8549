"""Continuous-batching serve engine over a paged KV cache (port of
``repro/serve/continuous.py``, DESIGN.md Sec. 14 and 15).

A fixed set of ``slots`` decodes in lockstep while requests stream
through them:

* **Paged KV cache.**  Every layer's cache is a page pool
  ``(num_pages, page_size, KV, hd)`` shared by all slots; a slot owns
  pages only through its row of the int32 block table.  Retiring a
  request returns its pages to the :class:`~repro_torch.serve.paged.PagePool`;
  admission takes them back.  Page 0 is the scratch page idle slots
  point at: their lockstep decode output is thrown away on the host.
* **Slot scheduler.**  Each step admits queued requests into free slots
  (arrival and pages permitting), runs ONE paged decode over all slots,
  then retires the slots that hit eos or their token budget.
* **Bucketed prefill.**  A prompt is right-padded to its power-of-two
  bucket, prefilled into a dense ``(1, bucket)`` cache through the flash
  kernel and packed into its slot's pages (the padded tail's K/V is
  overwritten position by position before ``k_valid_len`` exposes it).
  The first token comes from the logits at ``prompt_len - 1``.  With
  ``prefill_batch > 1`` up to that many queue-head requests of one bucket
  are admitted in one call, a loop of the per-request body, so each
  request's numbers are those of admitting it alone.
* **Speculative decoding** (``speculate_k > 0``).  The decode step
  becomes a round: snapshot the window rows ``[pos, pos + k]``, k draft
  steps through the first ``draft_layers`` blocks, ONE verify call of
  ``k + 1`` rows through the full model, the accept rule, and the window
  rows at or past the accepted length restored from the snapshot.
  Slots then advance raggedly, by 1 to k + 1 tokens.
* **Per-request streams.**  Sampled draws come from generators seeded by
  ``(seed, request id, absolute position, stream)``, never by slot: a
  refilled slot never reuses a retired request's stream, and a request's
  tokens are the same alone or sharing the batch.

The reference compiles one prefill executable per (bucket, admission
group size) and one decode executable; the port runs eagerly under
``torch.inference_mode()``.  ``dispatch_counter`` and
``num_executables`` still count what the reference's count (one entry
per (bucket, group size) seen, plus ``decode``), so ``run``'s statistics
have the reference's keys and, greedy, its values.  Each dispatch is
bracketed by :func:`repro_torch.trace.mark` (its dispatch name, then
``"end"``), so a caller can time it on the card; each loop iteration,
prefill, decode dispatch, decode's argument copies and decode launch is
a :func:`repro_torch.trace.span` (``"step"``, ``"prefill"``,
``"decode"``, ``"decode.prep"``, ``"decode.launch"``), so the host's time
between dispatches and inside them can be told from the card's.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import trace
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.blocks import layer_caches
from repro_torch.models.model import PagedCacheLayout

from .paged import PagePool, bucket_for, prompt_buckets
from .sampling import (DRAFT_STREAM, TOKEN_STREAM, SamplingParams,
                       sample_token, speculative_accept, stream_generator)


@dataclass
class _Slot:
    """Host-side state of one decode slot (free when ``rid is None``)."""
    rid: int | None = None
    pos: int = 0                 # next K/V write position (== length)
    generated: int = 0
    pages: list = field(default_factory=list)
    admitted_step: int = 0


@dataclass
class RequestResult:
    rid: int
    tokens: list                 # generated ids (incl. terminating eos)
    arrival: float
    admitted_step: int
    finished_step: int

    @property
    def wait_steps(self) -> float:
        """Queueing delay in virtual decode-step units."""
        return self.admitted_step - self.arrival


class ContinuousEngine:
    """See the module docstring.  ``run`` consumes a list of
    :class:`~repro_torch.serve.paged.Request` and returns per-request
    results and the scheduler's statistics.  Runs on ``cuda`` unless
    ``device`` says otherwise."""

    def __init__(self, cfg, *, slots: int, layout: PagedCacheLayout,
                 max_new: int, buckets=None, max_prompt: int = 48,
                 sampling: SamplingParams = SamplingParams(),
                 eos_id: int | None = None, param_dtype=torch.float32,
                 cache_dtype=torch.float32, speculate_k: int = 0,
                 draft_layers: int | None = None, prefill_batch: int = 1,
                 device=None):
        if slots < 1:
            raise ValueError(f"need >= 1 slot, got {slots}")
        if speculate_k < 0:
            raise ValueError(f"speculate_k must be >= 0, got {speculate_k}")
        if prefill_batch < 1:
            raise ValueError(
                f"prefill_batch must be >= 1, got {prefill_batch}")
        if speculate_k:
            if draft_layers is None:
                draft_layers = max(1, cfg.num_blocks // 2)
            if not 0 <= draft_layers <= cfg.num_blocks:
                raise ValueError(
                    f"draft_layers {draft_layers} outside "
                    f"[0, {cfg.num_blocks}]")
        elif draft_layers is not None:
            raise ValueError("draft_layers requires speculate_k > 0")
        self.speculate_k = speculate_k
        self.draft_layers = draft_layers
        self.prefill_batch = prefill_batch
        self.cfg = cfg
        self.slots = slots
        self.layout = layout
        self.max_new = max_new
        self.buckets = tuple(buckets) if buckets is not None \
            else prompt_buckets(max_prompt)
        for b in self.buckets:
            if b % layout.page_size:
                raise ValueError(f"bucket {b} not a multiple of page_size "
                                 f"{layout.page_size}")
        if max(self.buckets) > layout.max_seq:
            raise ValueError(
                f"largest bucket {max(self.buckets)} exceeds per-slot "
                f"capacity {layout.max_seq}")
        self.sampling = sampling
        self.eos_id = eos_id
        self.param_dtype = param_dtype
        self.cache_dtype = cache_dtype
        self.device = resolve_device(device)
        # the pools live across requests; init validates the architecture
        self.pools = M.init_paged_cache(cfg, layout, cache_dtype,
                                        self.device)
        self.page_pool = PagePool(layout.num_pages)
        # what the reference compiles: one prefill per (bucket, group
        # size) seen, one decode; dispatch_counter counts calls of each
        self._prefill_seen: set[tuple[int, int]] = set()
        self._decode_seen = False
        self.dispatch_counter: dict[str, int] = {}

    @property
    def num_executables(self) -> int:
        return len(self._prefill_seen) + self._decode_seen

    def _dispatch(self, name: str) -> None:
        self.dispatch_counter[name] = self.dispatch_counter.get(name, 0) + 1
        trace.mark(name)

    # -- device work ----------------------------------------------------

    def _prefill(self, params, group, bl: int, seed: int) -> list[int]:
        """Prefill each ``(request, slot, pages)`` of ``group`` (one
        bucket ``bl``) into its pages; returns the first tokens."""
        with trace.span("prefill", [r.rid for r, _, _ in group],
                        allocs=self.device.type == "cuda"):
            cfg, dev, ps = self.cfg, self.device, self.layout.page_size
            npg = bl // ps
            out = []
            for r, _, pages in group:
                toks = torch.zeros((1, bl), dtype=torch.int64, device=dev)
                toks[0, :r.prompt_len] = torch.tensor(r.tokens, device=dev)
                caches = M.init_cache(cfg, 1, bl, self.cache_dtype, dev)
                h, caches, _ = M.backbone(cfg, params, toks, caches=caches,
                                          cache_index=0)
                # the prompt's last real row, not the padded row bl - 1
                logits = M.logits_of(cfg, params, h[:, r.prompt_len - 1])
                gens = ([stream_generator(seed, r.rid, r.prompt_len,
                                          TOKEN_STREAM, dev)]
                        if self.sampling.needs_rng else None)
                out.append(sample_token(logits.float(), self.sampling, gens))
                pidx = torch.tensor(pages[:npg], device=dev)
                for pool, dense in zip(layer_caches(self.pools),
                                       layer_caches(caches)):
                    for name in pool:
                        pool[name][pidx] = dense[name][0].reshape(
                            (npg, ps) + dense[name].shape[2:])
            return torch.cat(out).tolist()

    def _generators(self, rids, positions, stream: int, seed: int):
        if not self.sampling.needs_rng:
            return None
        return [stream_generator(seed, -1 if rid is None else rid, p, stream,
                                 self.device)
                for rid, p in zip(rids, positions)]

    def _decode(self, params, table, tok, pos, hpos, rids, seed: int):
        """One lockstep decode over all slots (``pos`` on the device,
        ``hpos`` the same on the host): the next tokens (B,)."""
        with trace.span("decode.launch", rids,
                        allocs=self.device.type == "cuda"):
            logits, _ = M.decode_step(self.cfg, params, self.pools,
                                      tok[:, None], pos, decode_mode="paged",
                                      block_table=table)
            gens = self._generators(rids, [p + 1 for p in hpos],
                                    TOKEN_STREAM, seed)
            return sample_token(logits[:, -1].float(), self.sampling, gens)

    def _spec_round(self, params, table, tok, pos, hpos, rids, seed: int):
        """One draft-k-verify-once round over all slots: ``(emitted
        (B, k+1), counts (B,))``, each slot's first ``counts`` columns its
        tokens; the rejected window rows are already rolled back."""
        cfg, k, ps = self.cfg, self.speculate_k, self.layout.page_size
        win = pos[:, None] + torch.arange(k + 1, device=self.device)
        wpage = table.long().gather(1, win // ps)
        wslot = win % ps
        saved = [{n: c[n][wpage, wslot] for n in c}
                 for c in layer_caches(self.pools)]
        cur, dlg, dtk = tok, [], []
        for i in range(k):
            lg, _ = M.decode_step(cfg, params, self.pools, cur[:, None],
                                  pos + i, decode_mode="paged",
                                  block_table=table,
                                  draft_layers=self.draft_layers)
            lg = lg[:, -1].float()
            gens = self._generators(rids, [p + 1 + i for p in hpos],
                                    DRAFT_STREAM, seed)
            cur = sample_token(lg, self.sampling, gens)
            dlg.append(lg)
            dtk.append(cur)
        dtk = torch.stack(dtk, dim=1)                            # (B, k)
        vt = torch.cat([tok[:, None], dtk], dim=1)
        vlg, _ = M.decode_step(cfg, params, self.pools, vt, pos,
                               decode_mode="paged", block_table=table)
        streams = [(seed, -1 if rid is None else rid) for rid in rids]
        acc, emit = speculative_accept(vlg, torch.stack(dlg, dim=1), dtk,
                                       self.sampling, streams,
                                       [p + 1 for p in hpos])
        keep = torch.arange(k + 1, device=self.device)[None, :] \
            < (acc + 1)[:, None]
        for c, s in zip(layer_caches(self.pools), saved):
            for n in c:
                rows = c[n][wpage, wslot]
                mask = keep.reshape(keep.shape + (1,) * (rows.ndim - 2))
                c[n][wpage, wslot] = torch.where(mask, rows, s[n])
        return emit, acc + 1

    # -- scheduler ------------------------------------------------------

    def run(self, params, requests, *, seed: int = 0,
            max_steps: int = 100_000) -> dict:
        """Drive the trace to completion.  Returns ``{"results": {rid:
        RequestResult}, "stats": {...}}``, the statistics in virtual time
        (decode-step index)."""
        if params.embed.table.dtype != self.param_dtype:
            raise TypeError(f"engine built for {self.param_dtype} params, "
                            f"got {params.embed.table.dtype}")
        layout, dev = self.layout, self.device
        maxp = layout.max_pages_per_slot
        queue = deque(sorted(requests, key=lambda r: (r.arrival, r.rid)))
        for r in queue:
            if r.prompt_len + self.max_new + self.speculate_k \
                    > layout.max_seq:
                raise ValueError(
                    f"request {r.rid}: prompt {r.prompt_len} + max_new "
                    f"{self.max_new} + speculate_k {self.speculate_k} "
                    f"exceeds slot capacity {layout.max_seq}")
        slots = [_Slot() for _ in range(self.slots)]
        table = np.zeros((self.slots, maxp), np.int32)   # row 0s = scratch
        last_tok = np.zeros((self.slots,), np.int64)
        toks: dict[int, list] = {}
        results: dict[int, RequestResult] = {}
        arrivals = {r.rid: r.arrival for r in queue}
        step = busy_acc = spec_rounds = spec_accepted = 0

        def retire(s: _Slot, fin_step: int):
            self.page_pool.free(s.pages)
            i = slots.index(s)
            table[i] = 0
            last_tok[i] = 0
            results[s.rid] = RequestResult(
                rid=s.rid, tokens=toks.pop(s.rid), arrival=arrivals[s.rid],
                admitted_step=s.admitted_step, finished_step=fin_step)
            s.rid, s.pos, s.generated, s.pages = None, 0, 0, []

        with torch.inference_mode():
            while queue or any(s.rid is not None for s in slots):
                if step >= max_steps:
                    raise RuntimeError(f"trace did not drain in {max_steps} "
                                       f"steps")
                with trace.span("step", step):
                    # admission: free slots take arrived requests, grouped
                    # into one prefill call per shared bucket
                    free = [i for i, s in enumerate(slots) if s.rid is None]
                    while free and queue and queue[0].arrival <= step \
                            and self.page_pool.available >= maxp:
                        group = []           # [(request, slot, pages)]
                        bl = None
                        while queue and queue[0].arrival <= step \
                                and len(group) < min(len(free),
                                                     self.prefill_batch) \
                                and self.page_pool.available >= maxp:
                            b = bucket_for(queue[0].prompt_len,
                                           self.buckets)
                            if bl is None:
                                bl = b
                            elif b != bl:    # the head needs another bucket
                                break
                            group.append((queue.popleft(), free.pop(0),
                                          self.page_pool.alloc(maxp)))
                        nb = len(group)
                        self._prefill_seen.add((bl, nb))
                        self._dispatch(f"prefill_{bl}" if nb == 1
                                       else f"prefill_{bl}x{nb}")
                        first = self._prefill(params, group, bl, seed)
                        trace.mark("end")
                        for (r, i, pages), t0 in zip(group, first):
                            s = slots[i]
                            table[i] = pages
                            s.rid, s.pos, s.generated = r.rid, r.prompt_len, 1
                            s.pages, s.admitted_step = pages, step
                            toks[r.rid] = [t0]
                            last_tok[i] = t0
                            if self.max_new == 1 or t0 == self.eos_id:
                                retire(s, step)
                    # one lockstep decode over all slots
                    active = [s.rid is not None for s in slots]
                    if any(active):
                        busy_acc += sum(active)
                        self._decode_seen = True
                        self._dispatch("decode")
                        with trace.span("decode", step):
                            with trace.span("decode.prep", step):
                                hpos = [s.pos for s in slots]
                                args = (params,
                                        torch.from_numpy(table).to(dev),
                                        torch.from_numpy(last_tok).to(dev),
                                        torch.tensor(hpos, device=dev), hpos,
                                        [s.rid for s in slots], seed)
                            if self.speculate_k:
                                emit, cnt = self._spec_round(*args)
                                emit, cnt = emit.tolist(), cnt.tolist()
                            else:
                                emit = [[t] for t in
                                        self._decode(*args).tolist()]
                                cnt = [1] * self.slots
                        trace.mark("end")
                        for i, s in enumerate(slots):
                            if s.rid is None:
                                continue
                            out = emit[i][:cnt[i]]
                            if self.speculate_k:
                                spec_rounds += 1
                                spec_accepted += cnt[i] - 1
                            if self.eos_id is not None \
                                    and self.eos_id in out:
                                out = out[:out.index(self.eos_id) + 1]
                            out = out[:self.max_new - s.generated]
                            toks[s.rid].extend(out)
                            s.pos += len(out)
                            s.generated += len(out)
                            last_tok[i] = out[-1]
                            if out[-1] == self.eos_id \
                                    or s.generated >= self.max_new:
                                retire(s, step)
                step += 1

        waits = np.array([r.wait_steps for r in results.values()])
        lens = np.array([len(r.tokens) for r in results.values()])
        stats = {
            "steps": step,
            "requests": len(results),
            "generated_tokens": int(lens.sum()),
            "slot_utilization": float(busy_acc / max(step * self.slots, 1)),
            "executables": self.num_executables,
            "buckets_used": sorted(
                {int(k.split("_")[1].split("x")[0])
                 for k in self.dispatch_counter
                 if k.startswith("prefill_")}),
            "wait_p50_steps": float(np.percentile(waits, 50)),
            "wait_p99_steps": float(np.percentile(waits, 99)),
            "dispatches": dict(self.dispatch_counter),
        }
        if self.speculate_k:
            stats["speculative"] = {
                "rounds": spec_rounds,
                "drafted": spec_rounds * self.speculate_k,
                "accepted": spec_accepted,
                "acceptance_rate": float(
                    spec_accepted / max(spec_rounds * self.speculate_k, 1)),
                "tokens_per_round": float(
                    (spec_rounds + spec_accepted) / max(spec_rounds, 1)),
            }
        return {"results": results, "stats": stats}
