"""Serving launcher: the fixed-batch engine (port of
``repro/launch/serve.py``).

    python -m repro_torch.launch.serve --arch gemma3-1b --batch 4 \
        --prompt-len 1024 --gen 64 [--sample --temperature 0.8 \
        --top-k 40 --top-p 0.95] [--eos-id 1] [--reduced] [--device cpu]

Random weights from ``--seed`` (full width in bf16, ``--reduced`` in
f32), a random prompt batch, one warm-up generation (it builds the CUDA
kernels on first use), then one timed generation reporting steady-state
tokens/s.  Runs on the card unless ``--device cpu`` is given; without a
card it exits with an error.  The reference's ``--continuous`` and
``--speculate-k`` modes are not ported yet.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.serve.buckets import bucket_for, prompt_buckets


def plan_shapes(prompt_len: int, page_size: int = 8):
    """The bucket list covering prompts up to ``prompt_len`` and the
    bucketed padded length of a ``prompt_len`` prompt."""
    buckets = prompt_buckets(max(prompt_len, page_size),
                             min_bucket=page_size)
    return buckets, bucket_for(prompt_len, buckets)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="max prompt length; rounded up to its bucket")
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--sample", action="store_true",
                    help="sample instead of greedy argmax")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0,
                    help="truncate sampling to the k most likely tokens "
                         "(0 = full vocab)")
    ap.add_argument("--top-p", type=float, default=0.0,
                    help="nucleus sampling mass (0 or 1 = disabled)")
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="stop token id (>= 0 enables the done-mask)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import model as M
    from repro_torch.serve import SamplingParams, make_engine

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from None
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dtype = torch.float32 if args.reduced else torch.bfloat16
    params = M.init(cfg, seed=args.seed, dtype=dtype, device=device)
    sampling = SamplingParams(
        mode="sample" if args.sample else "greedy",
        temperature=args.temperature,
        top_k=args.top_k if args.top_k > 0 else None,
        top_p=args.top_p if 0.0 < args.top_p < 1.0 else None)
    eos_id = args.eos_id if args.eos_id >= 0 else None

    _, padded_len = plan_shapes(args.prompt_len)
    if padded_len != args.prompt_len:
        print(f"prompt-len {args.prompt_len} -> bucket {padded_len}")
    B = args.batch
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed + 1)       # prompts: a stream of their own
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, padded_len),
                                     generator=gen, device=device)}
    engine = make_engine(cfg, batch=B, prompt_len=padded_len,
                         max_new=args.gen, sampling=sampling, eos_id=eos_id,
                         param_dtype=dtype, cache_dtype=dtype, device=device)

    def timed():
        t0 = time.perf_counter()
        res = engine.generate_with_state(params, batch, seed=args.seed)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return res, time.perf_counter() - t0

    _, t_first = timed()     # warm-up: builds the kernels on first use
    res, dt = timed()
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print("generated token ids:")
    for row in res.tokens.tolist():
        print("  ", row)
    n_tok = int(res.lengths.sum())
    print(f"first call (incl. kernel build): {t_first:.2f}s")
    print(f"steady state on {where}: {dt:.3f}s for {n_tok} tokens "
          f"({n_tok / dt:.1f} tok/s, {dt / args.gen * 1e3:.1f} ms/step, "
          f"batch {B})")
    if eos_id is not None:
        print(f"done mask: {res.done.tolist()}  "
              f"lengths: {res.lengths.tolist()}")


if __name__ == "__main__":
    main()
