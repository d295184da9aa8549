#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero and prints no result line):

1. Card and build: the card's name and power limit, then the CUDA
   kernel of the serving path built from the sources in this checkout.
2. Each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (full-width gemma3-1b: B=4, prompt 1024,
   64 new tokens), in bf16 and f32, plus a ragged and a softcap case,
   element by element: |kernel - plain| <= 1e-4, plus 2^-7 |plain| in
   bf16 (one bf16 rounding step, as each side rounds its f32 result).
   Times are CUDA-event medians of 25 launches after warm-up, with the
   50 MB L2 flushed before each launch.  ``library_ms`` times PyTorch's
   ``scaled_dot_product_attention`` on the same inputs as a yardstick;
   the port never calls it.
3. The main path: full-width gemma3-1b in bf16 (random weights from a
   seed), ``make_engine(batch=4, prompt_len=1024, max_new=64)``, one
   warm-up generation, then one timed greedy generation whose kernel
   launches are counted (26 layers x 64 model passes); then prefill and
   the 63 decode steps each alone, timed, their launches counted apart.
4. The port on the card against the port on the CPU: reduced gemma3-1b
   in f32, greedy tokens equal and prefill logits within 1e-4.
5. ``--profile`` only: a profiler trace of one decode step, kernel time
   by name (what bounds a step).

The line before the last is a JSON object with one entry per kernel
and main-path shape; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,   # dense tensor-core bf16
              "float32": 67e12}     # f32 outside the tensor cores

# gemma3-1b main path (src/repro_torch/configs/gemma3_1b.py)
BATCH, PROMPT, NEW = 4, 1024, 64
SEQ = PROMPT + NEW
HEADS, KV_HEADS, HEAD_DIM, LOCAL_WINDOW = 4, 1, 256, 512


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def attention_work(*, B, Tq, H, KV, D, Dv, q0, k_valid, window, elt):
    """Bytes and FLOPs the attention call must move and do for these
    inputs: each (query, visible key) pair costs 2*(D + Dv) FLOPs; the
    bytes are q and out once plus the K/V rows any query can see."""
    lo_all, hi_all, pairs = None, None, 0
    for t in range(Tq):
        qpos = q0 + t
        hi = min(k_valid, qpos + 1)
        lo = max(0, qpos - window + 1) if window else 0
        pairs += max(0, hi - lo)
        lo_all = lo if lo_all is None else min(lo_all, lo)
        hi_all = hi if hi_all is None else max(hi_all, hi)
    flops = 2.0 * B * H * pairs * (D + Dv)
    keys = max(0, hi_all - lo_all)
    nbytes = elt * (B * Tq * H * (D + Dv) + B * KV * keys * (D + Dv))
    return nbytes, flops


def check_close(torch, got, want):
    """The kernel against its plain version, element by element: f32
    sums in another order (1e-4), plus in bf16 one rounding step of each
    element (2^-7 |want|).  Returns (max abs err, worst err / tol, ok);
    a NaN fails."""
    diff = (got.float() - want.float()).abs()
    tol = 1e-4 + (2.0 ** -7 * want.float().abs()
                  if got.dtype == torch.bfloat16 else 0.0)
    return (float(diff.max()), float((diff / tol).max()),
            bool((diff <= tol).all()))


def bound_ms(nbytes, flops, dtype_name):
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, flush, runs=25, warmup=3):
    """Median CUDA-event time of ``fn`` over ``runs`` launches, the L2
    cache flushed (outside the timed region) before each."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_build(torch):
    from repro_torch.kernels import _build
    print(f"[build] flash_attention.cu in "
          f"{_build.build('flash_attention'):.1f}s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_kernels(torch, dev):
    """Kernel vs plain on the card; returns (phase, JSON entry) for each
    timed bf16 main-path shape, the phase ("prefill" or "decode") whose
    launches the entry reports."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def inputs(dtype, Tq, S, D, Dv, k_valid, poison):
        q = torch.randn(BATCH, Tq, HEADS, D, generator=gen, device=dev)
        k = torch.randn(BATCH, S, KV_HEADS, D, generator=gen, device=dev)
        v = torch.randn(BATCH, S, KV_HEADS, Dv, generator=gen, device=dev)
        fill = float("nan") if poison else 0.0     # the cache's empty tail
        k[:, k_valid:] = fill
        v[:, k_valid:] = fill
        return q.to(dtype), k.to(dtype), v.to(dtype)

    def library(q, k, v, *, q0, k_valid, window, softcap, scale):
        """SDPA on the same inputs (boolean mask for causal, window and
        the valid prefix): the yardstick, or None where it has no
        counterpart (softcap)."""
        if softcap is not None:
            return None
        Tq, S = q.shape[1], k.shape[1]
        qpos = q0 + torch.arange(Tq, device=dev)[:, None]
        kpos = torch.arange(S, device=dev)[None, :]
        mask = (kpos <= qpos) & (kpos < k_valid)
        if window:
            mask &= kpos > qpos - window
        kk = torch.where(kpos[0, :, None, None] < k_valid, k, 0)
        vv = torch.where(kpos[0, :, None, None] < k_valid, v, 0)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, kk, vv))
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True)

    cases = []
    for layer, window in (("local", LOCAL_WINDOW), ("global", None)):
        cases.append((f"prefill,{layer}", PROMPT, 0, PROMPT, window, None,
                      HEAD_DIM, HEAD_DIM, False, True))
        for q0 in (PROMPT, SEQ - 2):
            cases.append((f"decode@{q0},{layer}", 1, q0, q0 + 1, window,
                          None, HEAD_DIM, HEAD_DIM, False, True))
    cases.append(("ragged,local", 77, 900, 977, LOCAL_WINDOW, None,
                  HEAD_DIM, HEAD_DIM, True, False))
    cases.append(("softcap,global", 77, 900, 977, None, 50.0,
                  HEAD_DIM, HEAD_DIM, True, False))

    entries = []
    print("[kernels] case dtype max_abs_err worst_err/tol")
    for (name, Tq, q0, k_valid, window, softcap, D, Dv, poison,
         main_path) in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = inputs(dtype, Tq, SEQ, D, Dv, k_valid, poison)
            kw = dict(window=window, softcap=softcap)
            want = ref.grouped_sdpa_ref(q, k, v, q_pos0=q0,
                                        k_valid_len=k_valid, **kw)
            got = flash_attention_fwd(q, k, v, q_start=q0,
                                      k_valid_len=k_valid, **kw)
            torch.cuda.synchronize()
            err, worst, ok = check_close(torch, got, want)
            dname = str(dtype).split(".")[1]
            print(f"[kernels] {name} {dname} {err:.3e} {worst:.3f}")
            if not ok:
                raise SystemExit(f"flash attention {name} {dname}: max abs "
                                 f"err {err}, {worst} x its tolerance")
            if not (main_path and dtype == torch.bfloat16):
                continue
            fa = lambda: flash_attention_fwd(  # noqa: E731
                q, k, v, q_start=q0, k_valid_len=k_valid, **kw)
            plain = lambda: ref.grouped_sdpa_ref(  # noqa: E731
                q, k, v, q_pos0=q0, k_valid_len=k_valid, **kw)
            lib = library(q, k, v, q0=q0, k_valid=k_valid, scale=D ** -0.5,
                          **kw)
            nbytes, flops = attention_work(
                B=BATCH, Tq=Tq, H=HEADS, KV=KV_HEADS, D=D, Dv=Dv, q0=q0,
                k_valid=k_valid, window=window, elt=q.element_size())
            b_ms, b_by = bound_ms(nbytes, flops, dname)
            entry = {
                "name": f"flash_attention[{name},{dname}]",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:310",
                "launches": None,
                "max_abs_err": err,
                "ms": time_ms(torch, fa, flush),
                "plain_ms": time_ms(torch, plain, flush),
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": None if lib is None else time_ms(torch, lib,
                                                               flush),
            }
            print(f"[kernels] {entry['name']}: {entry['ms']:.4f} ms "
                  f"(bound {b_ms:.4f} ms by {b_by}; plain "
                  f"{entry['plain_ms']:.4f} ms; sdpa "
                  f"{entry['library_ms']} ms)")
            entries.append((name.split("@")[0].split(",")[0], entry))
    del flush
    return entries


def phase_main_path(torch, dev, card):
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models import model as M
    from repro_torch.serve import make_engine

    cfg = get_config("gemma3-1b")
    t0 = time.perf_counter()
    params = M.init(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[main] gemma3-1b full width: {cfg.num_layers} layers, "
          f"{n_params / 1e9:.3f} B params in bf16, init "
          f"{time.perf_counter() - t0:.1f}s")
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device=dev)
    engine = make_engine(cfg, batch=BATCH, prompt_len=PROMPT, max_new=NEW,
                         param_dtype=torch.bfloat16,
                         cache_dtype=torch.bfloat16, device=dev)
    engine.generate(params, {"tokens": tokens})          # warm-up
    torch.cuda.synchronize()

    flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    res = engine.generate_with_state(params, {"tokens": tokens})
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {"generation": flash_attention_fwd.launches}

    # each phase alone, timed, its launches counted from zero
    with torch.inference_mode():
        flash_attention_fwd.launches = 0
        t0 = time.perf_counter()
        logits, caches = M.prefill(cfg, params, {"tokens": tokens}, SEQ,
                                   torch.bfloat16)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches["prefill"] = flash_attention_fwd.launches
        tok = logits[:, -1].argmax(-1)
        steps = [tok]
        flash_attention_fwd.launches = 0
        t0 = time.perf_counter()
        for i in range(1, NEW):                          # greedy, as above
            logits, caches = M.decode_step(cfg, params, caches, tok[:, None],
                                           PROMPT + i - 1)
            tok = logits[:, -1].argmax(-1)
            steps.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        launches["decode"] = flash_attention_fwd.launches

    L = cfg.num_layers
    for phase, want in (("generation", L * NEW), ("prefill", L),
                        ("decode", L * (NEW - 1))):
        if launches[phase] != want:
            raise SystemExit(f"flash attention launched {launches[phase]} "
                             f"times in the {phase}, expected {want}")
    toks = res.tokens
    if toks.shape != (BATCH, NEW) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise SystemExit(f"bad tokens: shape {tuple(toks.shape)}")
    print(f"[main] {card}: generation {total_s * 1e3:.2f} ms "
          f"(prefill {prefill_s * 1e3:.2f} ms, decode "
          f"{decode_s / (NEW - 1) * 1e3:.3f} ms/step alone, "
          f"{(total_s - prefill_s) / (NEW - 1) * 1e3:.3f} ms/step as "
          f"(generation - prefill) / {NEW - 1}), "
          f"{BATCH * NEW / total_s:.1f} tokens/s end to end, "
          f"{BATCH * (NEW - 1) / decode_s:.1f} decode tokens/s")
    # floors: a decode step reads every weight once (the tied table for
    # the logits included); prefill does 2 FLOPs per non-embedding weight
    # per prompt token
    n_embed = cfg.vocab_size * cfg.d_model
    decode_floor = n_params * 2 / H100_BYTES_PER_S * 1e3
    prefill_floor = (2.0 * (n_params - n_embed) * BATCH * PROMPT
                     / PEAK_FLOPS["bfloat16"] * 1e3)
    print(f"[main] floors: prefill >= {prefill_floor:.3f} ms (operations), "
          f"decode >= {decode_floor:.3f} ms/step (bytes of weights)")
    print(f"[main] flash attention launches: generation "
          f"{launches['generation']} (= {L} layers x {NEW} model passes), "
          f"prefill {launches['prefill']}, decode {launches['decode']}")
    print(f"[main] first tokens: {toks[:, :8].tolist()}; the phases alone "
          f"give the engine's tokens: "
          f"{torch.equal(torch.stack(steps, 1), toks)}")
    return launches, params, engine, tokens


def phase_cpu_vs_card(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import make_engine

    cfg = get_config("gemma3-1b").reduced()
    cpu = M.init(cfg, seed=3, dtype=torch.float32, device="cpu")
    card = M.Model(cfg, dtype=torch.float32, device=dev)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(4))
    logits = {}
    out = {}
    for name, params, d in (("cpu", cpu, torch.device("cpu")),
                            ("card", card, dev)):
        t = tokens.to(d)
        with torch.inference_mode():
            logits[name], _ = M.prefill(cfg, params, {"tokens": t}, 24,
                                        torch.float32)
        eng = make_engine(cfg, batch=2, prompt_len=16, max_new=8,
                          param_dtype=torch.float32,
                          cache_dtype=torch.float32, device=d)
        out[name] = eng.generate(params, {"tokens": t})[0].cpu()
    err = float((logits["card"].cpu() - logits["cpu"]).abs().max())
    print(f"[cpu-vs-card] reduced gemma3-1b f32: prefill logits max abs "
          f"err {err:.3e} (tol 1e-4); greedy tokens equal: "
          f"{torch.equal(out['cpu'], out['card'])}")
    if not err <= 1e-4:
        raise SystemExit(f"card vs cpu prefill logits differ by {err}")
    if not torch.equal(out["cpu"], out["card"]):
        raise SystemExit(f"greedy tokens differ: cpu {out['cpu'].tolist()} "
                         f"card {out['card'].tolist()}")


def phase_profile(torch, dev, params, engine, tokens):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model as M

    cfg = engine.cfg
    with torch.inference_mode():
        _, caches = M.prefill(cfg, params, {"tokens": tokens}, SEQ,
                              torch.bfloat16)
        tok = tokens[:, -1:]
        M.decode_step(cfg, params, caches, tok, PROMPT)   # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(4):
                M.decode_step(cfg, params, caches, tok, PROMPT + 1 + i)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 4
    from torch.autograd import DeviceType
    per_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, n = per_kernel.get(e.name, (0.0, 0))
            per_kernel[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    busy = sum(t for t, _ in per_kernel.values()) / 4 / 1e3
    print(f"[profile] decode step: wall {wall * 1e3:.3f} ms, device busy "
          f"{busy:.3f} ms ({100 * busy / (wall * 1e3):.1f}%)")
    for name, (us, n) in sorted(per_kernel.items(),
                                key=lambda kv: -kv[1][0])[:12]:
        print(f"[profile] {us / 4 / 1e3:9.4f} ms/step {n // 4:5d}x "
              f"{name[:90]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one decode step with torch.profiler")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs on "
                         "the card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: src/repro_torch not found beside "
                         f"{Path(__file__).name}; run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    phase_build(torch)
    entries = phase_kernels(torch, dev)
    launches, params, engine, tokens = phase_main_path(torch, dev, card)
    for phase, e in entries:
        e["launches"] = launches[phase]
    phase_cpu_vs_card(torch, dev)
    if args.profile:
        phase_profile(torch, dev, params, engine, tokens)
    print(card)
    print(json.dumps({"kernels": [e for _, e in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
