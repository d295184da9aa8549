"""Runner of the serving cells: continuous batching through the port's
``repro_torch.serve.continuous.ContinuousEngine.run``, requests arriving
as an open loop in the engine's own time (decode steps).

Set-up draws the weights on the card, builds the engine, and warms it
with one request per bucket of the traffic file (every prefill shape and
the one decode shape).  The trace holds the requests that arrive in
``--seconds`` at the traffic file's nominal step time (``step_s``, the
port's measured step when the cell was defined), so every run of a seed
does the same work; the window is the run, from its call to its
return.  The harness watches the run from a subclass that only adds
host clock readings around the engine's own dispatches: each dispatch's
start, each prefill's end (its first token is on the host then) and each
decode's end (after a synchronise the engine would make next anyway).

Time to first token: from the request's arrival, laid onto the wall
clock between the starts of the steps around it, to the end of its
prefill.
Time per output token: from its first token to the end of the decode
that gave its last, over its tokens less one.

``correct``: at a few decode steps drawn from the seed the subclass keeps
what the step found (tokens, positions, block table, the page pools) and
the rows it wrote; after the window the float32 reference
(``reference/<config>.py``) recomputes those steps from that cache (the
routing and its capacity depend on every slot of the step, so a step is
replayed whole), and from the prompt alone the prefill of one request
active at each kept step and of the longest prompt.  It judges every
served token by how far its logit lies below the reference's best, slot
by slot as well as over all, and the K/V rows the port wrote against its
own: the step's, the prompt's in the pages, and every cached row of the
first layer in the live slots' pages, which it works out from the prompt
and the tokens served alone (:func:`numbers`).
"""
from __future__ import annotations

import gc
import math
import statistics

import numpy as np
import torch

from perfbench import arith, lib


def _engine_class(ContinuousEngine):
    class Watched(ContinuousEngine):
        """The engine with host clock readings at its dispatches, and the
        cache of a few decode steps kept for the reference."""

        def watch(self, keep=(), fault=None, tracer=None, traced=(0, 0),
                  marks=None):
            self.events = []             # [name, start, end]
            self.first = {}              # rid -> time of its first token
            self.n_decode = 0
            self.keep, self.kept, self.fault = set(keep), [], fault
            self.tracer, self.traced, self.marks = tracer, traced, marks
            self.slice = None            # [mark i0, i1, t0, t1, event i0, i1]

        def _dispatch(self, name):
            if self.tracer is not None and name == "decode" \
                    and self.n_decode == self.traced[0]:
                torch.cuda.synchronize()
                self.slice = [len(self.marks), None, lib.now(), None,
                              len(self.events), None]
                self.tracer.__enter__()
            self.events.append([name, lib.now(), None])
            super()._dispatch(name)

        def _prefill(self, params, group, bl, seed):
            out = super()._prefill(params, group, bl, seed)
            t = lib.now()
            self.events[-1][2] = t
            self.events[-1].append([r.rid for r, _, _ in group])
            for r, _, _ in group:
                self.first[r.rid] = t
            return out

        def _decode(self, params, table, tok, pos, hpos, rids, seed):
            k = self.n_decode
            self.n_decode += 1
            snap = None
            if k in self.keep:
                snap = {"tok": tok.clone(), "pos": pos.clone(),
                        "table": table.clone(), "rids": list(rids),
                        "pools": [(c["k"].clone(), c["v"].clone())
                                  for c in _layers(self.pools)]}
            out = super()._decode(params, table, tok, pos, hpos, rids, seed)
            if self.fault == "token":
                out = torch.where(torch.tensor([r is not None for r in rids],
                                               device=out.device),
                                  (out + 1) % self.cfg.vocab_size, out)
            elif self.fault == "slot" and rids[0] is not None:
                # one slot serves a wrong token at every step it is live
                out = out.clone()
                out[0] = (out[0] + 1) % self.cfg.vocab_size
            elif self.fault == "half_batch":
                live = [b for b, r in enumerate(rids) if r is not None]
                left = torch.tensor(live[len(live) // 2:], dtype=torch.long,
                                    device=out.device)
                # the slots left out serve what an unwritten buffer holds
                junk = torch.Generator(device=out.device).manual_seed(k)
                out = out.clone()
                out[left] = torch.randint(
                    self.cfg.vocab_size, (len(left),), generator=junk,
                    device=out.device)
            if self.fault == "kv_write" and rids[0] is not None:
                # one slot's first-layer key row lands a position early
                ps = self.layout.page_size
                c = _layers(self.pools)[0]
                p0 = int(pos[0])
                if p0 > 0:
                    at = [table[0, q // ps].long() for q in (p0, p0 - 1)]
                    c["k"][at[1], (p0 - 1) % ps] = c["k"][at[0], p0 % ps]
            if snap is not None:
                ps = self.layout.page_size
                page = table.long().gather(1, (pos.long() // ps)[:, None])[:, 0]
                snap["rows"] = [(c["k"][page, pos.long() % ps].clone(),
                                 c["v"][page, pos.long() % ps].clone())
                                for c in _layers(self.pools)]
                snap["out"] = out.clone()
                self.kept.append(snap)
            if out.is_cuda:
                torch.cuda.synchronize()
            self.events[-1][2] = lib.now()
            if self.slice is not None and self.slice[1] is None \
                    and self.n_decode == self.traced[1]:
                self.tracer.__exit__(None, None, None)
                self.slice[1] = len(self.marks) + 1      # with this "end"
                self.slice[3] = lib.now()
                self.slice[5] = len(self.events)
            return out

    return Watched


def _layers(pools):
    from repro_torch.models.blocks import layer_caches
    return list(layer_caches(pools))


def _steps(events):
    """The run's dispatches grouped into decode steps: each group is the
    prefills of a step and its decode, in order."""
    groups, cur = [], []
    for ev in events:
        cur.append(ev)
        if ev[0] == "decode":
            groups.append(cur)
            cur = []
    if cur:
        raise RuntimeError("the run ended without a decode after a prefill")
    return groups


def _due(at: dict, arrival: float) -> float:
    """The wall time a request arrived: its arrival in decode steps laid
    onto the starts of the steps around it (a step's start is its first
    dispatch).  Where the engine stood idle at the step before, nothing
    ran until the step that admitted it, which is then its arrival."""
    fl = math.floor(arrival)
    if fl in at and fl + 1 in at:
        t0, t1 = at[fl][0][1], at[fl + 1][0][1]
        return t0 + (arrival - fl) * (t1 - t0)
    return at[math.ceil(arrival)][0][1]


def run(*, config: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device: str = "cuda", fault: str | None = None,
        per_layer=(), t_start: float | None = None,
        controls: bool = False) -> dict:
    from repro_torch import trace as marks_mod
    from repro_torch.models import model as M
    from repro_torch.models.model import PagedCacheLayout
    from repro_torch.serve.continuous import ContinuousEngine
    from repro_torch.serve.paged import Request

    t_start = lib.now() if t_start is None else t_start
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    gen = lib.load_module("traffic", "serve.py")
    pcfg = lib.port_config(config)
    specs = M.param_specs(pcfg, torch.bfloat16)
    w = lib.draw_weights(specs, seed, torch.bfloat16, dev)
    model = M.Model(pcfg, dtype=torch.bfloat16, device="meta")
    model.load_state_dict(w, assign=True)
    model.eval()
    slots, ps = traffic["slots"], traffic["page_size"]
    buckets, max_new = tuple(traffic["buckets"]), traffic["max_new"]
    maxp = -(-(max(buckets) + max_new) // ps)
    layout = PagedCacheLayout(page_size=ps, num_pages=slots * maxp + 1,
                              max_pages_per_slot=maxp)
    eng = _engine_class(ContinuousEngine)(
        pcfg, slots=slots, layout=layout, max_new=max_new, buckets=buckets,
        param_dtype=torch.bfloat16, cache_dtype=torch.bfloat16, device=dev)
    run_seed = seed % 2 ** 31

    # warm-up: a request of each bucket's length, all due at once: every
    # prefill shape and the one decode shape
    eng.watch()
    eng.run(model, [Request(rid=10 ** 9 + i, tokens=tuple(range(1, b + 1)),
                            arrival=0.0) for i, b in enumerate(buckets)],
            seed=run_seed)
    # the same work in every run: as many requests as arrive in
    # ``seconds`` at the traffic's nominal step time, less the drain
    n_req = max(8, round(traffic["rate_per_step"]
                         * (seconds / traffic["step_s"] - max_new)))
    reqs = [Request(rid=i, tokens=toks, arrival=a) for i, (toks, a) in
            enumerate(gen.requests(traffic, config["vocab_size"], seed,
                                   n_req))]
    est_steps = reqs[-1].arrival + max_new
    rng = np.random.default_rng([seed, 2])
    keep = sorted({int(f * est_steps) for f in
                   rng.uniform(0.25, 0.75, traffic["kept_steps"])})
    marks = None
    if cuda:
        torch.cuda.synchronize()
    t0 = lib.now()
    setup_s = t0 - t_start
    if trace:
        # the profiler over ``traced_steps`` decode steps from 40% of the
        # way in; the phase marks of the other steps give the spans
        k0 = int(0.4 * est_steps)
        with marks_mod.cuda_marks() as marks:
            eng.watch(keep, fault, lib.Trace(),
                      (k0, k0 + traffic["traced_steps"]), marks)
            res = eng.run(model, reqs, seed=run_seed)
            torch.cuda.synchronize()
    else:
        eng.watch(keep, fault)
        res = eng.run(model, reqs, seed=run_seed)
    t1 = lib.now()
    window = t1 - t0
    results = res["results"]

    groups = _steps(eng.events)
    active = sorted({s for r in results.values()
                     for s in range(r.admitted_step, r.finished_step + 1)})
    if len(active) != len(groups):
        raise RuntimeError(f"{len(groups)} decode dispatches for "
                           f"{len(active)} active steps")
    at = dict(zip(active, groups))
    ttft, tpot, tokens = [], [], 0
    for r in results.values():
        ttft.append(eng.first[r.rid] - _due(at, r.arrival))
        n_tok = len(r.tokens)
        tokens += n_tok
        if n_tok > 1:
            tpot.append((at[r.finished_step][-1][2] - eng.first[r.rid])
                        / (n_tok - 1))
    out = {"attempted": len(reqs), "failed": len(reqs) - len(results),
           "metrics": {"serve_tokens_per_s": tokens / window,
                       "ttft_ms_p95": 1e3 * lib.percentile(ttft, 95),
                       "tpot_ms_p95": 1e3 * lib.percentile(tpot, 95),
                       "setup_s": setup_s},
           "window_s": window, "steps": len(groups)}
    if cuda:
        out["device"] = lib.device_record()
    if trace:
        out.update(_per_layer(config, traffic, reqs, results, active, groups,
                              marks, eng.tracer, eng.slice, per_layer,
                              window))
    kept = eng.kept
    prompts = {r.rid: r.tokens for r in reqs}
    firsts = {rid: r.tokens[0] for rid, r in results.items()}
    served = {rid: tuple(r.tokens) for rid, r in results.items()}
    del eng, res, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = lib.now()
    state = rng.bit_generator.state
    f32 = readings(config, traffic, w, kept, prompts, served, rng)
    got = numbers(f32)
    out["checks"] = {k: [got[k], lim] for k, lim in traffic["limits"].items()}
    out["readings"] = got
    if controls:
        rng.bit_generator.state = state
        out["control"] = numbers(f32, readings(config, traffic, w, kept,
                                               prompts, served, rng, "fp8"))
    out["reference_s"] = lib.now() - t_ref
    return out


def readings(config, traffic, w, kept, prompts, served, rng,
             precision="f32"):
    """Per kept step and per prefill checked, what the reference gives:
    ``decode``: [(logits (B, V), the served tokens, the active mask, the
    fresh rows, the rows the program wrote)]; ``pages``: [(the reference's
    first-layer K and V rows of every active slot's cached positions,
    worked out from its prompt and the tokens it was served, and the
    program's rows in the pages)], one per kept step; ``prefill``:
    [(logits (V,), the first token, the reference's prompt rows, the
    program's prompt rows or None)].  With ``precision="fp8"`` the logits
    and rows are the control's."""
    ref = lib.load_module("reference", f"{config['name']}.py")
    ref.P.strict()
    pr = ref.P.Precision(precision)
    buckets = traffic["buckets"]
    ps = traffic["page_size"]
    dec, pages, pre = [], [], []
    todo = []                           # (rid, the program's prompt rows)
    with torch.no_grad():
        for snap in kept:
            act = torch.tensor([r is not None for r in snap["rids"]])
            dev = snap["tok"].device
            snap = dict(snap, active=act.to(dev))
            logits, fresh = ref.decode(config, w, snap, pr)
            dec.append((logits.cpu(), snap["out"].cpu(), act, fresh,
                        snap["rows"]))
            live = [b for b, r in enumerate(snap["rids"]) if r is not None]
            # the first layer's rows of each live slot, which earlier
            # decode steps and the prefill wrote, from its tokens alone
            toks, pos, prog = [], [], ([], [])
            pk, pv = snap["pools"][0]
            for b in live:
                rid = snap["rids"][b]
                n = int(snap["pos"][b])
                toks += list((prompts[rid] + served[rid])[:n])
                rows = torch.arange(n, device=dev)
                pos.append(rows)
                page = snap["table"][b].long()[rows // ps]
                prog[0].append(pk[page, rows % ps])
                prog[1].append(pv[page, rows % ps])
            if live:
                k, v = ref.first_layer_kv(
                    config, w, torch.tensor(toks, device=dev),
                    torch.cat(pos), pr)
                pages.append(((k.cpu(), v.cpu()),
                              (torch.cat(prog[0]).cpu(),
                               torch.cat(prog[1]).cpu())))
                b = live[int(rng.integers(len(live)))]
                rid = snap["rids"][b]
                n = len(prompts[rid])
                rows = torch.arange(n, device=dev)
                page = snap["table"][b].long()[rows // ps]
                todo.append((rid, [(k[page, rows % ps], v[page, rows % ps])
                                   for k, v in snap["pools"]]))
        longest = max(prompts, key=lambda r: len(prompts[r]))
        todo.append((longest, None))
        dev = next(iter(w.values())).device
        for rid, rows in todo:
            toks = prompts[rid]
            bl = min(b for b in buckets if b >= len(toks))
            padded = torch.zeros(bl, dtype=torch.int64, device=dev)
            padded[:len(toks)] = torch.tensor(toks, device=dev)
            logits, kv = ref.prefill(config, w, padded, len(toks), pr)
            pre.append((logits.cpu(), served[rid][0], kv, rows))
    return {"decode": dec, "pages": pages, "prefill": pre}


def _rel(prog, ref):
    """Each row's (a token's K or V over heads) relative L2 gap between the
    program's rows and the reference's."""
    p, r = prog.float().flatten(1), ref.float().flatten(1)
    return (torch.linalg.vector_norm(p - r, dim=1)
            / torch.linalg.vector_norm(r, dim=1).clamp_min(1e-30)).cpu()


def numbers(got: dict, control: dict | None = None) -> dict:
    """The numbers ``correct`` can compare.  Each logit gap is the
    reference's best logit less its logit of the token judged: the token
    the program served, or with ``control`` (the same readings in the
    lower precision) the token the control puts first.  ``decode_gap``
    and ``prefill_gap`` are the widest gaps, ``gap_mean`` the mean over
    every token judged and ``mismatch`` the share of them that is not the
    reference's best; ``slot_gap`` is the largest, over the slots live at
    three kept steps or more, of the median of the slot's gaps (a slot
    that serves wrong tokens shows, a token that capacity routing flips
    does not); ``kv_err`` is the widest relative gap of a K or V row,
    ``kv_med`` the widest over layers of the median row's, ``kv0`` the
    widest in the first layer (routing cannot reach it), over the fresh
    rows, the prompt rows checked and every cached row of the kept steps'
    live slots."""
    gaps = []
    per_slot: dict[int, list] = {}
    per_layer: dict[int, list] = {}
    for i, (logits, served, act, fresh, rows) in enumerate(got["decode"]):
        pick = served if control is None else \
            control["decode"][i][0].argmax(-1)
        gap = logits.max(-1).values \
            - logits.gather(1, pick[:, None].long())[:, 0]
        gaps += gap[act].tolist()
        for b in act.nonzero()[:, 0].tolist():
            per_slot.setdefault(b, []).append(float(gap[b]))
        other = rows if control is None else control["decode"][i][3]
        for layer, ((fk, fv), (pk, pv)) in enumerate(zip(fresh, other)):
            a = act.to(fk.device)
            per_layer.setdefault(layer, []).append(
                torch.cat([_rel(pk[a], fk[a]), _rel(pv[a], fv[a])]))
    dgap = max(gaps, default=0.0)
    for i, ((rk, rv), (pk, pv)) in enumerate(got["pages"]):
        if control is not None:
            pk, pv = control["pages"][i][0]
        per_layer.setdefault(0, []).append(
            torch.cat([_rel(pk, rk), _rel(pv, rv)]))
    pgap = 0.0
    for i, (logits, first, ref_kv, rows) in enumerate(got["prefill"]):
        pick = first if control is None else \
            int(control["prefill"][i][0].argmax())
        gap = float(logits.max() - logits[pick])
        gaps.append(gap)
        pgap = max(pgap, gap)
        if control is not None:
            rows = control["prefill"][i][2]
        if rows is not None:
            for layer, ((rk, rv), (pk, pv)) in enumerate(zip(ref_kv, rows)):
                per_layer.setdefault(layer, []).append(
                    torch.cat([_rel(pk, rk), _rel(pv, rv)]))
    errs = {k: torch.cat(v) for k, v in per_layer.items()}
    slots = [statistics.median(v) for v in per_slot.values() if len(v) >= 3]
    return {"decode_gap": dgap, "prefill_gap": pgap,
            "gap_mean": sum(gaps) / max(len(gaps), 1),
            "mismatch": sum(g > 0 for g in gaps) / max(len(gaps), 1),
            "slot_gap": max(slots, default=float("nan")),
            "kv_err": max(float(e.max()) for e in errs.values()),
            "kv_med": max(float(e.median()) for e in errs.values()),
            "kv0": float(errs[0].max())}


def _per_layer(config, traffic, reqs, results, active, groups, marks,
               tracer, sl, names, window) -> dict:
    """Per-layer metrics: kernels and idle share from the profiled decode
    steps (and the prefills between them), spans and the run's share of
    the peak from the other steps."""
    dev_events, host = tracer.events()
    red = lib.reduce_trace(dev_events, host)
    i0, i1, s0, s1, e0, e1 = sl
    H, KV, hd = config["num_heads"], config["num_kv_heads"], config["head_dim"]
    L = config["num_hidden_layers"]
    slots = traffic["slots"]
    n_of = {r.rid: len(r.tokens) for r in reqs}
    live: dict[int, list] = {s: [] for s in active}
    for r in results.values():
        for s in range(r.admitted_step, r.finished_step + 1):
            live[s].append(n_of[r.rid] + (s - r.admitted_step) + 1)
    paged, flash, flops = [], [], 0.0
    for i, (s, ev) in enumerate((s, ev) for s, g in zip(active, groups)
                                for ev in g):
        traced = e0 <= i < e1
        if ev[0] == "decode":
            if traced:
                lengths = live[s] + [1] * (slots - len(live[s]))
                paged += [arith.paged_decode_work(
                    lengths=lengths, heads=H, kv_heads=KV, hd=hd)] * L
            else:
                flops += sum(arith.decoder_token_flops(config, c)
                             for c in live[s])
        elif traced:
            bl = int(ev[0].split("_")[1])
            flash += [arith.flash_work(batch=1, heads=H, kv_heads=KV, hd=hd,
                                       tq=bl, s=bl, causal=True)] * L
        else:
            flops += sum(arith.prefill_flops(config, n_of[rid])
                         for rid in ev[3])
    traced = traffic["traced_steps"]
    ctx = {"marks": lib.mark_spans(marks[:i0]) + lib.mark_spans(marks[i1:]),
           "window_s": window - (s1 - s0), "slice_s": s1 - s0,
           "busy_per_step_s": red["busy_s"] / traced,
           "wall_per_step_s": (window - (s1 - s0)) / (len(groups) - traced),
           "kernel_s": lib.kernel_seconds(dev_events), "busy_s": red["busy_s"],
           "work": {"flash": flash, "paged_flash": paged}, "flops": flops}
    return {"per_layer": lib.read_metrics(names, ctx),
            "busy_s": red["busy_s"], "traced_s": s1 - s0,
            "breakdown": {"device_ops": red["device_ops"],
                          "idle_gaps": red["idle_gaps"]}}
