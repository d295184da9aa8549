"""Decentralized training launcher: one gossip node per process, or a
node over several processes of a mesh (the counterpart of
``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch gemma3-1b --nproc 3 \
        --backend gloo --topology base --k 1 --method dsgdm --eta 0.01 \
        --steps 4 --batch 6 --seq 1024 [--compress int8] \
        [--flatten-gossip] [--overlap] [--ckpt-dir DIR --ckpt-every N] \
        [--mesh-data D] [--mesh-model M | --production-mesh single] \
        [--reduced] [--device cpu]

``--nproc N`` starts N local ranks (``launch.distributed.spawn_local``),
the counterpart of the reference's ``--devices N``.  Without it, the
process is one rank of a group described by the rank flags or the
REPRO_* variables (``--coordinator --num-processes --process-id``), as
each process of a multi-host deployment is started.  Every rank starts
from the same parameters (``models.model.init`` with seed 0; full width
in bf16, ``--reduced`` in f32), takes rows ``r*b:(r+1)*b`` of the global
batch of ``data.synthetic.token_batches`` (b = batch / nodes; for
llava-next-34b and seamless-m4t-large-v2 with 16 stub patch or frame
embeddings per sequence, drawn per step from a stream of their own, as
the reference's launcher) and prints its loss per step; with
``--nproc`` the launcher then prints the mean over nodes. As the
reference's launcher, it checkpoints each pattern block at full width
and not with ``--reduced`` (``remat=not reduced``). Runs on the card
unless ``--device cpu`` is given; without a card it
exits with an error.

``--overlap`` runs each step's update and gossip group by group
(``dist.steps.make_train_step(overlap=True)``), bit for bit the
sequential step.  With ``--ckpt-dir`` and ``--ckpt-every N`` each rank
saves ``{"params", "opt", "step"}`` under the name ``latest`` after step
``s`` whenever ``s and s % N == 0``, asynchronously
(``checkpoint.AsyncCheckpointer``, one shard file per rank) while
training goes on; after the last step it waits for the writes, and rank
0 saves the node-mean of the parameters under the name ``ckpt``, as the
reference's launcher does (``launch/train.py:129-151``).  There is no
resume flag, as there is none in the reference: a run resumes from
``checkpoint.load_pytree`` of ``latest`` and the step bundle.

``--mesh-model M`` (and ``--mesh-data D``, by default the ranks // M)
lays the ranks out as a live ``(data, model)`` mesh, as the reference's
launcher builds its mesh (``launch/train.py:77-83``), and
``--production-mesh single|multi`` as the (16, 16) or (2, 16, 16)
production mesh, which needs 256 or 512 ranks.  The ranks then train
tensor-parallel (``dist.steps.make_train_step(mesh=)``): every rank
draws the same parameters and keeps its shard under the train rules
(``convert.shard_for_rank``), takes its node's rows of the global
batch (its share of them where the rules split the rows), and gossips
its shards over the node axis; each rank prints its node's loss, and
``--nproc`` prints the mean over the nodes, each node counted once.
``--compress`` chunks each shard on its own, as the reference's
tensor-parallel mixer does.  ``--ckpt-dir`` over a mesh: each rank
writes its shards with the global slices they cover
(``checkpoint.io.mesh_placement``), and the ranks of node 0 write the
node-mean ``ckpt``, each shard averaged over the node axis.
"""
from __future__ import annotations

import argparse
import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.distributed import (BACKENDS, add_distributed_args,
                                            config_from_args, initialize,
                                            spawn_local)
from repro_torch.launch.mesh import make_mesh, make_production_mesh


#: stub frontend frames (audio) or patches (vision) per sequence, as the
#: reference's launcher (``launch/train.py:115-127``), and the seed of
#: their stream (step s draws from ``STUB_SEED + s``)
STUB_LEN, STUB_SEED = 16, 1 << 20


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
    overlap: bool = False       # update and gossip group by group
    ckpt_dir: str | None = None
    ckpt_every: int = 0         # save "latest" every N steps (async)
    # a live mesh over the ranks: (data, model), data = ranks // model
    # when not given; or the production mesh "single" / "multi"
    mesh_data: int | None = None
    mesh_model: int = 1
    production_mesh: str | None = None


@dataclass
class TrainResult:
    losses: list                # this node's loss per step
    params: dict                # this node's final (1, ...) parameters
    state: dict                 # this node's final method state
    bundle: object              # the dist.steps.TrainStepBundle
    # one record per save of this rank (``AsyncCheckpointer.stats``:
    # name, save_ms on the step's thread, write_s, bytes)
    checkpoints: list = field(default_factory=list)


def mesh_layout(opts: TrainOptions, world: int):
    """``(shape, axis_names)`` of the mesh the ``world`` ranks train
    over, or None for one node per rank (no mesh flag); raises
    ``ValueError`` for a layout the ranks cannot fill."""
    if opts.production_mesh is not None:
        if opts.production_mesh not in ("single", "multi"):
            raise ValueError(f"--production-mesh is single or multi, got "
                             f"{opts.production_mesh!r}")
        mesh = make_production_mesh(
            multi_pod=opts.production_mesh == "multi")
        shape = tuple(mesh.shape.values())
        if math.prod(shape) != world:
            raise ValueError(f"--production-mesh {opts.production_mesh} is "
                             f"a {shape} mesh of {math.prod(shape)} ranks; "
                             f"the group has {world}")
        return shape, mesh.axis_names
    if opts.mesh_model == 1 and opts.mesh_data is None:
        return None
    model = opts.mesh_model
    if model < 1 or world % model:
        raise ValueError(f"--mesh-model {model} does not divide the "
                         f"{world} ranks")
    data = opts.mesh_data or world // model
    if data * model != world:
        raise ValueError(f"a (data {data}, model {model}) mesh needs "
                         f"{data * model} ranks; the group has {world}")
    return (data, model), ("data", "model")


def rank_batch(cfg, opts: TrainOptions, step: int, n: int, me: int,
               device) -> dict:
    """Rank ``me``'s ``(1, b, ...)`` rows of step ``step``'s global batch
    (``data.synthetic.token_batches``; stub patches or frames for the
    archs with a frontend, drawn by every rank for the global batch)."""
    from repro_torch.data.synthetic import token_batches
    from repro_torch.models.frontends import stub_inputs

    b = opts.batch // n
    dtype = torch.float32 if opts.reduced else torch.bfloat16
    raw = token_batches(step, batch=n * b, seq=opts.seq,
                        vocab=cfg.vocab_size)
    batch = {k: v.reshape(n, b, -1)[me:me + 1] for k, v in raw.items()}
    gen = torch.Generator(device=device).manual_seed(STUB_SEED + step)
    for k, v in stub_inputs(cfg, gen, n * b, STUB_LEN, dtype,
                            device).items():
        batch[k] = v.reshape((n, b) + v.shape[1:])[me:me + 1]
    return batch


def node_mean(params: dict, group=None) -> dict | None:
    """The mean over the group's nodes of their ``(1, ...)`` parameters,
    on rank 0 (None elsewhere): each tensor gathered to rank 0 in rank
    order, summed in f32 in that order, divided by n and cast back, as
    ``jnp.mean`` over the node axis computes it for bf16.  Run once,
    after training; under gloo the tensors travel through host memory."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    host = dist.get_backend(group) == "gloo"
    out = {} if me == 0 else None
    for k, x in params.items():
        x = x[0].detach()
        if not x.is_floating_point():
            if me == 0:
                out[k] = x.clone()
            continue
        buf = x.cpu() if host else x.contiguous()
        if me == 0:
            acc = x.float()
            for r in range(1, n):
                got = torch.empty_like(buf)
                dist.recv(got, dist.get_global_rank(group, r)
                          if group is not None else r, group=group)
                acc = acc + got.to(x.device).float()
            out[k] = (acc / n).to(x.dtype)
        else:
            dist.send(buf, dist.get_global_rank(group, 0)
                      if group is not None else 0, group=group)
    return out


def train_rank(opts: TrainOptions, device, group=None) -> TrainResult:
    """This rank's training loop, in a process that has joined the group
    (``launch.distributed.initialize``)."""
    from repro_torch.checkpoint import AsyncCheckpointer, save_pytree
    from repro_torch.configs import get_config
    from repro_torch.dist.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.sim.engine import node_stack

    cfg = get_config(opts.arch)
    if opts.reduced:
        cfg = cfg.reduced()
    n, me = dist.get_world_size(group), dist.get_rank(group)
    layout = mesh_layout(opts, n)
    if layout is not None:
        if group is not None:
            raise ValueError("a mesh is laid out over the default group")
        return _train_mesh(opts, cfg, device, make_mesh(*layout))
    if opts.batch % n:
        raise ValueError(f"--batch {opts.batch} does not split over {n} "
                         f"nodes")
    dtype = torch.float32 if opts.reduced else torch.bfloat16
    bundle = make_train_step(cfg, group, topology=opts.topology, k=opts.k,
                             method_name=opts.method, eta=opts.eta,
                             param_dtype=dtype, remat=opts.remat,
                             flatten_gossip=opts.flatten_gossip,
                             compression=opts.compress, overlap=opts.overlap)
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
    ckpt = (AsyncCheckpointer(opts.ckpt_dir, group=group)
            if opts.ckpt_dir else None)
    losses = []
    try:
        for step in range(opts.steps):
            params, opt, loss = bundle.step_fn(
                params, opt, rank_batch(cfg, opts, step, n, me, device),
                step)
            losses.append(loss.detach())
            if step % opts.log_every == 0 or step == opts.steps - 1:
                print(f"rank {me} step {step:5d}  loss {float(loss):.4f}  "
                      f"(round {step % bundle.n_rounds}/{bundle.n_rounds})",
                      flush=True)
            if ckpt is not None and opts.ckpt_every \
                    and step and step % opts.ckpt_every == 0:
                # Background write; the loop keeps stepping while this
                # snapshot streams to disk.
                ckpt.save({"params": params, "opt": opt, "step": step},
                          name="latest")
    finally:
        if ckpt is not None:
            ckpt.close()
    if opts.ckpt_dir:
        avg = node_mean(params, group)
        if me == 0:
            print("saved:", save_pytree(avg, opts.ckpt_dir), flush=True)
        del avg
    return TrainResult([float(x) for x in losses], params, opt, bundle,
                       ckpt.stats if ckpt is not None else [])


def _train_mesh(opts: TrainOptions, cfg, device, mesh) -> TrainResult:
    """:func:`train_rank` over a live ``mesh``: this rank's shards of its
    node's parameters and state, its node's batch rows, its node's
    loss per step."""
    from repro_torch.checkpoint import AsyncCheckpointer
    from repro_torch.checkpoint.io import mesh_placement
    from repro_torch.convert import shard_for_rank
    from repro_torch.dist.sharding import param_partition_specs
    from repro_torch.dist.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.sim.engine import node_stack

    dtype = torch.float32 if opts.reduced else torch.bfloat16
    bundle = make_train_step(cfg, mesh=mesh, topology=opts.topology,
                             k=opts.k, method_name=opts.method,
                             eta=opts.eta, param_dtype=dtype,
                             remat=opts.remat,
                             flatten_gossip=opts.flatten_gossip,
                             compression=opts.compress,
                             overlap=opts.overlap)
    n, node = bundle.n_nodes, bundle.node
    if opts.batch % n:
        raise ValueError(f"--batch {opts.batch} does not split over {n} "
                         f"nodes")
    me = dist.get_rank()
    if me == 0:
        shape = " x ".join(f"{a} {s}" for a, s in mesh.shape.items())
        print(f"mesh ({shape}): {n} node(s) on "
              f"{bundle.rules.node_axis or 'no axis'}, weights on "
              f"{bundle.rules.tp}, rows on {bundle.rules.dp or 'no axis'}; "
              f"topology spec: {bundle.spec.to_json()} "
              f"({bundle.n_rounds} rounds)", flush=True)
    full = M.init(cfg, seed=0, dtype=dtype, device=device).state_dict()
    specs = param_partition_specs(full, bundle.rules)
    shards = shard_for_rank(full, specs, mesh, mesh.coords)
    params = node_stack(shards, 1, device)
    del full, shards
    opt = bundle.method.init(params)
    node_axis = bundle.rules.node_axis if n > 1 else None
    ckpt = (AsyncCheckpointer(opts.ckpt_dir, placement=mesh_placement(
        specs, mesh, node_axis)) if opts.ckpt_dir else None)
    losses = []
    try:
        for step in range(opts.steps):
            params, opt, loss = bundle.step_fn(
                params, opt, rank_batch(cfg, opts, step, n, node, device),
                step)
            losses.append(loss.detach())
            if step % opts.log_every == 0 or step == opts.steps - 1:
                print(f"rank {me} {mesh.coords} node {node} step "
                      f"{step:5d}  loss {float(loss):.4f}  (round "
                      f"{step % bundle.n_rounds}/{bundle.n_rounds})",
                      flush=True)
            if ckpt is not None and opts.ckpt_every \
                    and step and step % opts.ckpt_every == 0:
                ckpt.save({"params": params, "opt": opt, "step": step},
                          name="latest")
    finally:
        if ckpt is not None:
            ckpt.close()
    if opts.ckpt_dir:
        _save_node_mean(opts.ckpt_dir, params, specs, mesh, node_axis)
    return TrainResult([float(x) for x in losses], params, opt, bundle,
                       ckpt.stats if ckpt is not None else [])


def _save_node_mean(directory, params, specs, mesh, node_axis) -> None:
    """The node-mean ``ckpt`` over a mesh: each shard averaged over the
    node axis (:func:`node_mean` over ``mesh.group(node_axis)``, on the
    ranks of node 0), which write it together, each its slices."""
    from repro_torch.checkpoint import AsyncCheckpointer
    from repro_torch.checkpoint.io import mesh_placement
    from repro_torch.launch.mesh import rank_coords

    world = dist.get_world_size()
    first = [r for r in range(world) if node_axis is None
             or rank_coords(mesh, r)[node_axis] == 0]
    # every rank makes the group, as new_group asks
    group = dist.new_group(first) if len(first) < world else None
    if node_axis is None:
        avg = {k: v[0].detach() for k, v in params.items()}
    else:
        avg = node_mean(params, mesh.group(node_axis))
    if avg is None:
        return
    ckpt = AsyncCheckpointer(directory, group=group, placement=mesh_placement(
        specs, mesh, node_axis, nodes=False))
    try:
        path = ckpt.save(avg, name="ckpt", node_axis=False).result()
    finally:
        ckpt.close()
    if dist.get_rank() == 0:
        print("saved:", path, flush=True)


def _spawned_rank(rank, device, opts):
    """One rank of :func:`launch`: its losses and what it sent, its node,
    and whether it is the first rank of its node (``lead``)."""
    res = train_rank(opts, device)
    rules = res.bundle.rules
    lead = rules is None or all(
        c == 0 for a, c in rules.mesh.coords.items()
        if a != rules.node_axis)
    return {"rank": rank, "device": str(device), "losses": res.losses,
            "sent": dict(res.bundle.mixer.stats), "node": res.bundle.node,
            "lead": lead}


def launch(opts: TrainOptions, *, nproc: int, backend: str = "gloo",
           device=None, timeout: float = 3600.0) -> list:
    """Train with ``nproc`` local ranks (``spawn_local``); returns each
    rank's ``{"rank", "device", "losses", "sent", "node", "lead"}`` in
    rank order.  A mesh layout the ranks cannot fill raises before any
    rank starts."""
    mesh_layout(opts, nproc)
    return spawn_local(_spawned_rank, nproc, args=(opts,), backend=backend,
                       device=device, timeout=timeout)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True,
                    help="gemma3-1b, gemma2-2b, granite-8b, qwen1.5-4b, "
                         "grok-1-314b, deepseek-v3-671b, mamba2-2.7b, "
                         "jamba-1.5-large-398b, llava-next-34b or "
                         "seamless-m4t-large-v2")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--nproc", type=int, default=None,
                    help="start N local ranks (one node each, or laid "
                         "out as the mesh the flags below give)")
    ap.add_argument("--backend", choices=BACKENDS, default="gloo",
                    help="nccl: one card per rank; gloo: the CPU, or ranks "
                         "sharing a card")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh-data", type=int, default=None,
                    help="ranks on the mesh's data axis (default: the "
                         "ranks // --mesh-model)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="ranks on the mesh's model axis (tensor "
                         "parallel)")
    ap.add_argument("--production-mesh", choices=["single", "multi"],
                    default=None,
                    help="the (16, 16) or (2, 16, 16) mesh: 256 or 512 "
                         "ranks")
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
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="also checkpoint (async) every N steps")
    ap.add_argument("--flatten-gossip", action="store_true")
    ap.add_argument("--overlap", action="store_true",
                    help="overlap gossip with the method update, group by "
                         "group (bit-exact vs sequential)")
    ap.add_argument("--compress", default=None,
                    help="gossip payload codec: identity|int8|fp8|int4|"
                         "topk, or an inline CompressionConfig JSON")
    add_distributed_args(ap)
    args = ap.parse_args(argv)

    opts = TrainOptions(
        arch=args.arch, reduced=args.reduced, topology=args.topology,
        k=args.k, method=args.method, eta=args.eta, steps=args.steps,
        batch=args.batch, seq=args.seq, compress=args.compress,
        flatten_gossip=args.flatten_gossip, log_every=args.log_every,
        remat=not args.reduced, overlap=args.overlap,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        mesh_data=args.mesh_data, mesh_model=args.mesh_model,
        production_mesh=args.production_mesh)
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
    # (nodes, steps): each node's losses once, from its first rank
    losses = np.asarray([r["losses"] for r in results
                         if r.get("lead", True)])
    mean = losses.mean(axis=0)
    for step in range(0, opts.steps, opts.log_every):
        print(f"step {step:5d}  loss {mean[step]:.4f}  (mean over "
              f"{len(losses)} nodes)")
    print(f"first-10 mean {mean[:10].mean():.4f}  last-10 mean "
          f"{mean[-10:].mean():.4f}")
    print("bytes sent per rank: "
          + ", ".join(str(r["sent"]["bytes"]) for r in results))


if __name__ == "__main__":
    main()
