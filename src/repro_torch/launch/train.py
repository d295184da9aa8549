"""Decentralized training launcher: one gossip node per process (the
counterpart of ``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch gemma3-1b --nproc 3 \
        --backend gloo --topology base --k 1 --method dsgdm --eta 0.01 \
        --steps 4 --batch 6 --seq 1024 [--compress int8] \
        [--flatten-gossip] [--reduced] [--device cpu]

``--nproc N`` starts N local ranks (``launch.distributed.spawn_local``),
the counterpart of the reference's ``--devices N``.  Without it, the
process is one rank of a group described by the rank flags or the
REPRO_* variables (``--coordinator --num-processes --process-id``), as
each process of a multi-host deployment is started.  Every rank starts
from the same parameters (``models.model.init`` with seed 0; full width
in bf16, ``--reduced`` in f32), takes rows ``r*b:(r+1)*b`` of the global
batch of ``data.synthetic.token_batches`` (b = batch / nodes) and prints
its loss per step; with ``--nproc`` the launcher then prints the mean
over nodes.  As the reference's launcher, it checkpoints each pattern
block at full width and not with ``--reduced`` (``remat=not reduced``).
Runs on the card unless ``--device cpu`` is given; without a card it
exits with an error.

Not ported yet (they raise): ``--mesh-model > 1`` (tensor-parallel
meshes), ``--production-mesh``, ``--overlap`` and ``--ckpt-dir``.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.distributed import (BACKENDS, add_distributed_args,
                                            config_from_args, initialize,
                                            spawn_local)


@dataclass(frozen=True)
class TrainOptions:
    arch: str = "gemma3-1b"
    reduced: bool = False
    topology: str = "base"
    k: int = 1
    method: str = "dsgdm"
    eta: float = 0.01
    steps: int = 100
    batch: int = 8              # global batch, split over the nodes
    seq: int = 128
    compress: str | None = None
    flatten_gossip: bool = False
    log_every: int = 10
    remat: bool = True          # checkpoint each pattern block


@dataclass
class TrainResult:
    losses: list                # this node's loss per step
    params: dict                # this node's final (1, ...) parameters
    state: dict                 # this node's final method state
    bundle: object              # the dist.steps.TrainStepBundle


def train_rank(opts: TrainOptions, device, group=None) -> TrainResult:
    """This rank's training loop, in a process that has joined the group
    (``launch.distributed.initialize``)."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.dist.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.sim.engine import node_stack

    cfg = get_config(opts.arch)
    if opts.reduced:
        cfg = cfg.reduced()
    n, me = dist.get_world_size(group), dist.get_rank(group)
    if opts.batch % n:
        raise ValueError(f"--batch {opts.batch} does not split over {n} "
                         f"nodes")
    b = opts.batch // n
    dtype = torch.float32 if opts.reduced else torch.bfloat16
    bundle = make_train_step(cfg, group, topology=opts.topology, k=opts.k,
                             method_name=opts.method, eta=opts.eta,
                             param_dtype=dtype, remat=opts.remat,
                             flatten_gossip=opts.flatten_gossip,
                             compression=opts.compress)
    if me == 0:
        print(f"topology spec: {bundle.spec.to_json()} ({bundle.n_rounds} "
              f"rounds, {bundle.plan.max_slots} slot(s) per round at most)",
              flush=True)
        if bundle.compression is not None:
            print(f"compressed gossip: {bundle.compression.to_json()}",
                  flush=True)
    params = node_stack(M.init(cfg, seed=0, dtype=dtype,
                               device=device).state_dict(), 1, device)
    opt = bundle.method.init(params)
    losses = []
    for step in range(opts.steps):
        raw = token_batches(step, batch=n * b, seq=opts.seq,
                            vocab=cfg.vocab_size)
        batch = {k: v.reshape(n, b, -1)[me:me + 1] for k, v in raw.items()}
        params, opt, loss = bundle.step_fn(params, opt, batch, step)
        losses.append(loss.detach())
        if step % opts.log_every == 0 or step == opts.steps - 1:
            print(f"rank {me} step {step:5d}  loss {float(loss):.4f}  "
                  f"(round {step % bundle.n_rounds}/{bundle.n_rounds})",
                  flush=True)
    return TrainResult([float(x) for x in losses], params, opt, bundle)


def _spawned_rank(rank, device, opts):
    """One rank of :func:`launch`: its losses and what it sent."""
    res = train_rank(opts, device)
    return {"rank": rank, "device": str(device), "losses": res.losses,
            "sent": dict(res.bundle.mixer.stats)}


def launch(opts: TrainOptions, *, nproc: int, backend: str = "gloo",
           device=None, timeout: float = 3600.0) -> list:
    """Train with ``nproc`` local ranks (``spawn_local``); returns each
    rank's ``{"rank", "device", "losses", "sent"}`` in rank order."""
    return spawn_local(_spawned_rank, nproc, args=(opts,), backend=backend,
                       device=device, timeout=timeout)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True,
                    help="gemma3-1b, gemma2-2b, granite-8b, qwen1.5-4b, "
                         "grok-1-314b or deepseek-v3-671b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--nproc", type=int, default=None,
                    help="start N local ranks, one node each")
    ap.add_argument("--backend", choices=BACKENDS, default="gloo",
                    help="nccl: one card per rank; gloo: the CPU, or ranks "
                         "sharing a card")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--production-mesh", choices=["single", "multi"],
                    default=None)
    ap.add_argument("--topology", default="base",
                    help="registered topology name, or an inline JSON "
                         "TopologySpec, e.g. '{\"name\":\"base\",\"k\":2}' "
                         "(n is the node count)")
    ap.add_argument("--k", type=int, default=1)
    ap.add_argument("--method", default="dsgdm")
    ap.add_argument("--eta", type=float, default=0.01)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--flatten-gossip", action="store_true")
    ap.add_argument("--overlap", action="store_true")
    ap.add_argument("--compress", default=None,
                    help="gossip payload codec: identity|int8|fp8|int4|"
                         "topk, or an inline CompressionConfig JSON")
    add_distributed_args(ap)
    args = ap.parse_args(argv)

    for flag, unported in (("--mesh-model > 1", args.mesh_model > 1),
                           ("--production-mesh", args.production_mesh),
                           ("--overlap", args.overlap),
                           ("--ckpt-dir", args.ckpt_dir)):
        if unported:
            raise NotImplementedError(
                f"{flag} is not ported to repro_torch yet; see ROADMAP.md")
    opts = TrainOptions(
        arch=args.arch, reduced=args.reduced, topology=args.topology,
        k=args.k, method=args.method, eta=args.eta, steps=args.steps,
        batch=args.batch, seq=args.seq, compress=args.compress,
        flatten_gossip=args.flatten_gossip, log_every=args.log_every,
        remat=not args.reduced)
    rank_cfg = config_from_args(args)
    if args.nproc is None and rank_cfg.num_processes > 1:
        dev = initialize(rank_cfg, args.backend, args.device)
        try:
            train_rank(opts, dev)
        finally:
            dist.destroy_process_group()
        return
    results = launch(opts, nproc=args.nproc or 1, backend=args.backend,
                     device=args.device)
    losses = np.asarray([r["losses"] for r in results])    # (nodes, steps)
    mean = losses.mean(axis=0)
    for step in range(0, opts.steps, opts.log_every):
        print(f"step {step:5d}  loss {mean[step]:.4f}  (mean over "
              f"{len(results)} nodes)")
    print(f"first-10 mean {mean[:10].mean():.4f}  last-10 mean "
          f"{mean[-10:].mean():.4f}")
    print("bytes sent per rank: "
          + ", ".join(str(r["sent"]["bytes"]) for r in results))


if __name__ == "__main__":
    main()
