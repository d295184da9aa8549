"""Serving launcher: the fixed-batch engine or the continuous-batching
engine (port of ``repro/launch/serve.py``).

    python -m repro_torch.launch.serve --arch gemma3-1b --batch 4 \
        --prompt-len 1024 --gen 64 [--sample --temperature 0.8 \
        --top-k 40 --top-p 0.95] [--eos-id 1] [--reduced] [--device cpu]

``--arch`` is one of the dense zoo (gemma3-1b, gemma2-2b, granite-8b,
qwen1.5-4b), the MoE family (grok-1-314b, deepseek-v3-671b; at full
depth neither fits one card, so run them ``--reduced``; deepseek-v3-671b's
latent cache has no paged form, and ``--continuous`` raises for it, as in
the reference), the SSM family (mamba2-2.7b, which fits at full width
and depth, and the hybrid jamba-1.5-large-398b, ``--reduced``; a Mamba
layer's recurrent state has no paged form and takes no speculation, so
``--continuous`` and ``--speculate-k`` raise for both), llava-next-34b
(a stub vision prefix of 16 patch embeddings in front of the prompt,
``prefix_len=16``) or seamless-m4t-large-v2 (16 stub audio frames for
its encoder; ``--continuous`` and ``--speculate-k`` raise for it).
Random weights from ``--seed`` (full width in bf16, ``--reduced`` in
f32), a random prompt batch (and the stub frontend's embeddings, from a
stream of their own), one warm-up generation (it builds the CUDA kernels
on first use), then one timed generation reporting steady-state
tokens/s.

``--continuous`` serves a seeded Poisson trace through
:class:`repro_torch.serve.ContinuousEngine` over a paged KV cache,
requests admitted into decode slots as they free up:

    python -m repro_torch.launch.serve --arch gemma3-1b --continuous \
        --requests 32 --arrival-rate 0.5 --trace-seed 0 --slots 8 \
        --page-size 16 --prompt-len 1024 --gen 64 \
        [--speculate-k 4 --draft-layers 2] [--prefill-batch 2]

The fixed-batch engine speculates too, self-speculatively or through a
separate draft model (random weights from ``--seed`` + 1, reduced with
``--reduced``):

    python -m repro_torch.launch.serve --arch gemma3-1b --batch 4 \
        --prompt-len 1024 --gen 64 --speculate-k 4 \
        [--draft-layers 2 | --draft-config gemma3-1b]

``--nproc N`` serves the fixed-batch engine tensor-parallel over N local
ranks (``launch.distributed.spawn_local``, ``--backend gloo`` or
``nccl``) laid out as a ``(N // mesh_model, mesh_model)`` mesh, as the
reference's launcher builds its mesh (``launch/serve.py:142-144``):

    python -m repro_torch.launch.serve --arch gemma3-1b --batch 4 \
        --prompt-len 1024 --gen 32 --nproc 4 --mesh-model 2 \
        [--backend gloo] [--speculate-k 4 --draft-layers 2 |
         --speculate-k 4 --draft-config gemma3-1b]

Each rank draws the whole model on the CPU from ``--seed`` (so on the CPU
the weights, and the greedy tokens, are ``--nproc 1``'s), keeps its shard
under the serve rules (``convert.shard_for_rank``), moves it to its
device and serves its rows of the batch through ``make_engine(mesh=)``;
the launcher prints the tokens of every row, rank 0's timings and its
gathers.  A ``--draft-config`` model is drawn the same way (from
``--seed`` + 1) and sharded under the same serve rules.  ``--continuous``
takes no mesh, as the reference's continuous engine takes none.

Every shape (prompt padding, the bucket list, the trace's prompt range)
comes from :func:`plan_shapes`.  Runs on the card unless ``--device cpu``
is given; without a card it exits with an error.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.serve.paged import bucket_for, prompt_buckets

#: stub frontend frames (audio) or patches (vision) per request, as the
#: reference's launcher (``launch/serve.py:150-159``)
STUB_LEN = 16


def plan_shapes(prompt_len: int, page_size: int = 8):
    """The bucket list covering prompts up to ``prompt_len`` and the
    bucketed padded length of a ``prompt_len`` prompt."""
    buckets = prompt_buckets(max(prompt_len, page_size),
                             min_bucket=page_size)
    return buckets, bucket_for(prompt_len, buckets)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True,
                    help="gemma3-1b, gemma2-2b, granite-8b, qwen1.5-4b, "
                         "grok-1-314b, deepseek-v3-671b, mamba2-2.7b, "
                         "jamba-1.5-large-398b, llava-next-34b or "
                         "seamless-m4t-large-v2")
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
    # tensor-parallel serving over local ranks
    ap.add_argument("--nproc", type=int, default=1,
                    help="serve over this many local ranks (a mesh)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="[--nproc] ranks on the mesh's model axis; the "
                         "data axis takes nproc // mesh_model")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="[--nproc] gloo (CPU, or ranks sharing a card) or "
                         "nccl (a card per rank)")
    # speculative decoding (DESIGN.md Sec. 15)
    ap.add_argument("--speculate-k", type=int, default=0,
                    help="draft k tokens per round and verify them in one "
                         "pass (0 = plain decoding)")
    ap.add_argument("--draft-layers", type=int, default=0,
                    help="[speculative] early-exit depth of the "
                         "self-speculative draft in pattern blocks "
                         "(0 = num_blocks // 2)")
    ap.add_argument("--draft-config", default="",
                    help="[speculative, fixed-batch] arch name of a "
                         "separate draft model (mutually exclusive with "
                         "--draft-layers)")
    # continuous-batching frontend
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching paged engine instead of the "
                         "fixed-batch engine")
    ap.add_argument("--requests", type=int, default=32,
                    help="[continuous] number of requests in the trace")
    ap.add_argument("--arrival-rate", type=float, default=0.5,
                    help="[continuous] Poisson arrivals per decode step")
    ap.add_argument("--trace-seed", type=int, default=0,
                    help="[continuous] seed of the arrival/prompt trace")
    ap.add_argument("--slots", type=int, default=4,
                    help="[continuous] lockstep decode slots")
    ap.add_argument("--page-size", type=int, default=8,
                    help="[continuous] KV positions per cache page")
    ap.add_argument("--prefill-batch", type=int, default=1,
                    help="[continuous] admit up to this many same-bucket "
                         "requests per prefill call")
    args = ap.parse_args(argv)
    if args.draft_config and args.continuous:
        raise SystemExit("--draft-config is fixed-batch only; the "
                         "continuous engine speculates self-speculatively "
                         "(--draft-layers)")
    if args.nproc > 1 or args.mesh_model > 1:
        if args.continuous:
            raise SystemExit("--nproc serves the fixed-batch engine; "
                             "--continuous takes no mesh")
        if args.mesh_model < 1 or args.nproc % args.mesh_model:
            raise SystemExit(f"--mesh-model {args.mesh_model} does not "
                             f"divide --nproc {args.nproc}")
        _run_mesh(args)
        return

    import torch

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import model as M
    from repro_torch.models.frontends import stub_inputs
    from repro_torch.serve import make_engine

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from None
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dtype = torch.float32 if args.reduced else torch.bfloat16
    params = M.init(cfg, seed=args.seed, dtype=dtype, device=device)
    sampling = _sampling(args)
    eos_id = args.eos_id if args.eos_id >= 0 else None
    if args.continuous:
        _run_continuous(args, cfg, params, sampling, eos_id, dtype, device)
        return

    _, padded_len = plan_shapes(args.prompt_len)
    if padded_len != args.prompt_len:
        print(f"prompt-len {args.prompt_len} -> bucket {padded_len}")
    B = args.batch
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed + 1)       # prompts: a stream of their own
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, padded_len),
                                     generator=gen, device=device)}
    # the stub frontend's 16 frames or patches, a stream of their own
    gen.manual_seed(args.seed + 2)
    batch.update(stub_inputs(cfg, gen, B, STUB_LEN, dtype, device))
    npfx = STUB_LEN if "prefix_embeds" in batch else 0
    draft_cfg = draft_params = None
    if args.draft_config:
        draft_cfg = get_config(args.draft_config)
        if args.reduced:
            draft_cfg = draft_cfg.reduced()
        draft_params = M.init(draft_cfg, seed=args.seed + 1, dtype=dtype,
                              device=device)
    engine = make_engine(cfg, batch=B, prompt_len=padded_len,
                         max_new=args.gen, sampling=sampling, eos_id=eos_id,
                         prefix_len=npfx, param_dtype=dtype,
                         cache_dtype=dtype,
                         speculate_k=args.speculate_k,
                         draft_layers=args.draft_layers or None,
                         draft_cfg=draft_cfg, device=device)

    def timed():
        t0 = time.perf_counter()
        res = engine.generate_with_state(params, batch, seed=args.seed,
                                         draft_params=draft_params)
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
    if res.spec is not None:
        rounds = int(res.spec.rounds.sum())
        drafted = int(res.spec.drafted.sum())
        accepted = int(res.spec.accepted.sum())
        print(f"speculative: k={args.speculate_k}, {rounds} rounds, "
              f"acceptance {accepted}/{drafted} "
              f"({accepted / max(drafted, 1):.2f}); "
              f"{n_tok / max(rounds, 1):.2f} tokens per sequential pass")


def _sampling(args):
    from repro_torch.serve import SamplingParams
    return SamplingParams(
        mode="sample" if args.sample else "greedy",
        temperature=args.temperature,
        top_k=args.top_k if args.top_k > 0 else None,
        top_p=args.top_p if 0.0 < args.top_p < 1.0 else None)


def _serve_rank(rank, device, args):
    """One rank of ``--nproc``: the whole model drawn on the CPU, this
    rank's shard kept and moved to ``device``, its rows of the batch
    served twice (a warm-up, then timed)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import shard_for_rank
    from repro_torch.dist.sharding import (batch_partition_specs,
                                           make_rules,
                                           param_partition_specs)
    from repro_torch.dist.tp import bind
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models.frontends import stub_inputs
    from repro_torch.serve import make_engine

    mesh = make_host_mesh(model=args.mesh_model)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    rules = make_rules(mesh, arch_name=cfg.name, context="serve")
    dtype = torch.float32 if args.reduced else torch.bfloat16
    full = M.init(cfg, seed=args.seed, dtype=dtype,
                  device="cpu").state_dict()
    specs = param_partition_specs(full, rules)
    model = bind(cfg, {k: v.to(device) for k, v in shard_for_rank(
        full, specs, mesh, mesh.coords).items()}, mesh)
    draft_cfg = draft = None
    if args.draft_config:
        draft_cfg = get_config(args.draft_config)
        if args.reduced:
            draft_cfg = draft_cfg.reduced()
        dfull = M.init(draft_cfg, seed=args.seed + 1, dtype=dtype,
                       device="cpu").state_dict()
        draft = bind(draft_cfg, {k: v.to(device) for k, v in shard_for_rank(
            dfull, param_partition_specs(dfull, make_rules(
                mesh, arch_name=draft_cfg.name, context="serve")), mesh,
            mesh.coords).items()}, mesh)
        del dfull
    _, padded_len = plan_shapes(args.prompt_len)
    B = args.batch
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed + 1)       # prompts: as the one-rank path
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, padded_len),
                                     generator=gen, device=device)}
    gen.manual_seed(args.seed + 2)
    batch.update(stub_inputs(cfg, gen, B, STUB_LEN, dtype, device))
    engine = make_engine(
        cfg, batch=B, prompt_len=padded_len, max_new=args.gen,
        sampling=_sampling(args),
        eos_id=args.eos_id if args.eos_id >= 0 else None,
        prefix_len=STUB_LEN if "prefix_embeds" in batch else 0,
        param_dtype=dtype, cache_dtype=dtype, speculate_k=args.speculate_k,
        draft_layers=args.draft_layers or None, draft_cfg=draft_cfg,
        device=device, mesh=mesh)
    mine = shard_for_rank(batch, batch_partition_specs(
        batch, rules, node_stacked=False), mesh, mesh.coords)

    def timed():
        t0 = time.perf_counter()
        res = engine.generate_with_state(model, mine, seed=args.seed,
                                         draft_params=draft)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return res, time.perf_counter() - t0

    _, t_first = timed()     # warm-up: builds the kernels on first use
    before = dict(model.tp.stats)
    res, dt = timed()
    return {"row0": engine.row0, "tokens": res.tokens.tolist(),
            "n_tok": int(res.lengths.sum()), "t_first": t_first, "dt": dt,
            "gathers": {k: model.tp.stats[k] - before[k] for k in before},
            "where": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")}


def _run_mesh(args) -> None:
    from repro_torch.launch.distributed import spawn_local

    results = spawn_local(_serve_rank, args.nproc, args=(args,),
                          backend=args.backend, device=args.device)
    rows = {}
    for r in results:
        for i, row in enumerate(r["tokens"]):
            rows.setdefault(r["row0"] + i, row)
    print("generated token ids:")
    for i in sorted(rows):
        print("  ", rows[i])
    r0 = results[0]
    print(f"mesh (data {args.nproc // args.mesh_model}, model "
          f"{args.mesh_model}) over {args.nproc} {args.backend} ranks on "
          f"{r0['where']}")
    print(f"first call (incl. kernel build): {r0['t_first']:.2f}s")
    print(f"steady state, rank 0: {r0['dt']:.3f}s for its {r0['n_tok']} "
          f"tokens ({r0['n_tok'] / r0['dt']:.1f} tok/s, "
          f"{r0['dt'] / args.gen * 1e3:.1f} ms/step)")
    g = r0["gathers"]
    print(f"rank 0 gathers per generation: {g['collectives']} "
          f"({g['bytes']} bytes received)")


def _run_continuous(args, cfg, params, sampling, eos_id, dtype,
                    device) -> None:
    import time

    import torch

    from repro_torch.models.model import PagedCacheLayout
    from repro_torch.serve import ContinuousEngine, poisson_trace

    buckets, max_bucket = plan_shapes(args.prompt_len, args.page_size)
    # verify-window headroom: a speculative round writes up to
    # speculate_k rows past the last committed position
    max_pages = -(-(max_bucket + args.gen + args.speculate_k)
                  // args.page_size)
    layout = PagedCacheLayout(
        page_size=args.page_size,
        num_pages=args.slots * max_pages + 1,   # +1: reserved scratch page
        max_pages_per_slot=max_pages)
    trace = poisson_trace(args.requests, rate=args.arrival_rate,
                          seed=args.trace_seed, min_prompt=4,
                          max_prompt=args.prompt_len,
                          vocab_size=cfg.vocab_size)
    engine = ContinuousEngine(
        cfg, slots=args.slots, layout=layout, max_new=args.gen,
        buckets=buckets, sampling=sampling, eos_id=eos_id,
        param_dtype=dtype, cache_dtype=dtype, speculate_k=args.speculate_k,
        draft_layers=(args.draft_layers or None) if args.speculate_k
        else None, prefill_batch=args.prefill_batch, device=device)

    t0 = time.perf_counter()
    out = engine.run(params, trace, seed=args.seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    s = out["stats"]
    print(f"continuous trace: {s['requests']} requests, "
          f"{s['generated_tokens']} tokens in {s['steps']} decode steps")
    print(f"  executables (the reference's count): {s['executables']} "
          f"(buckets used {s['buckets_used']} + 1 decode; bound = "
          f"{len(buckets)} buckets x {args.prefill_batch} group sizes + 1 "
          f"= {len(buckets) * args.prefill_batch + 1})")
    print(f"  slot utilization: {s['slot_utilization']:.2f}  "
          f"queue wait p50/p99: {s['wait_p50_steps']:.1f}/"
          f"{s['wait_p99_steps']:.1f} steps")
    print(f"  wall on {where}: {dt:.2f}s, kernel builds included "
          f"({s['generated_tokens'] / dt:.1f} tok/s)")
    if "speculative" in s:
        sp = s["speculative"]
        print(f"  speculative: k={args.speculate_k}, {sp['rounds']} rounds, "
              f"acceptance {sp['acceptance_rate']:.2f}, "
              f"{sp['tokens_per_round']:.2f} tokens/round")
    for rid in sorted(out["results"])[:4]:
        print(f"  req {rid}: {out['results'][rid].tokens}")


if __name__ == "__main__":
    main()
