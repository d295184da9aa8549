"""Multi-pod dry run on the meta device (port of
``repro/launch/dryrun.py``).

For every (architecture x input shape x mesh) combination the reference
lowers and compiles its step on the 16x16 single-pod and the 2x16x16
multi-pod meshes, with no array allocated.  Here one rank of that mesh
(rank 0's coordinates, ``launch.mesh.dry_mesh``: no process group) runs
its step on the ``meta`` device: its shards of the parameters, its rows
of the batch, its cache, every activation and gradient have a shape and
a dtype and no storage, and the card is never touched.

* serving shapes: ``dist.steps.make_prefill`` / ``make_decode_step``
  over the model bound to the rank's shards (``dist.tp.bind``);
* ``train_4k``: one step of ``dist.steps.make_train_step(mesh=)``: the
  forward, the backward through the collectives, the sums over the row
  axes, the method's update and its gossip.

The tensor-parallel collectives run through ``dist.tp.DryCollectives``:
each gather's pieces are empty tensors of its shape, counted in the
``stats`` / ``backward_stats`` the live class keeps, and nothing is sent.
The gossip mixer runs on a dry wire (``dist.gossip``), which counts its
messages in the ``stats`` the live mixer keeps.  The kernels on these
paths (attention, the gossip combine, the fused DSGD step) take meta
tensors (``kernels.ops``: a shape function).

Each cell reports the rank's bytes of parameters, optimizer state (and
gradients), batch and cache, and whether they fit the card's 80 GB
(activations are not counted: the meta device allocates nothing); the
analytic FLOPs per rank (``analysis.flops``, the global count over the
mesh's ranks); the compute and HBM roofline terms at the H100's 989
TFLOP/s and 3.35 TB/s (``launch.mesh``; HBM: the rank's state bytes
above read once); the gathers and bytes a step makes, forward and
backward; for training the gossip bytes the step's mixer sent.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k \
        --mesh single --topology base --k 1 --out /tmp/dry
    python -m repro_torch.launch.dryrun --all --mesh both [--jobs 8]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor, as_completed

import torch

from repro_torch.analysis.flops import (forward_flops, model_flops,
                                        train_flops)
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.dist.sharding import (local_shape, make_rules,
                                       param_partition_specs)
from repro_torch.dist.steps import (local_rows, make_decode_step,
                                    make_prefill, make_train_step)
from repro_torch.dist.tp import bind
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, PEAK_FLOPS_BF16,
                                     dry_mesh, make_production_mesh)
from repro_torch.launch.shapes import (INPUT_SHAPES, config_for_shape,
                                       decode_inputs, prefill_batch_shapes,
                                       skip_reason, text_len,
                                       train_batch_shapes)
from repro_torch.models import model as M
from repro_torch.models.frontends import AUDIO_FRAMES


def _nbytes(tree) -> int:
    """The bytes of every tensor in nested dicts and lists."""
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def _meta_shards(cfg, rules, mesh, dtype, lead=()) -> dict:
    """The rank's shard of every parameter, on the meta device."""
    full = M.param_specs(cfg, dtype)
    specs = param_partition_specs(full, rules)
    return {k: torch.empty(lead + local_shape(t.shape, specs[k], mesh),
                           dtype=dtype, device="meta")
            for k, t in full.items()}


def _frames(batch: dict, frames: int) -> dict:
    """``batch`` with its audio frames (axis -2) cut to ``frames``."""
    if "frames" in batch:
        f = batch["frames"]
        batch = dict(batch, frames=f.new_empty(
            f.shape[:-2] + (frames, f.shape[-1])))
    return batch


def _gathers(comm, before, bwd_before) -> dict:
    fwd = {k: comm.stats[k] - before[k] for k in before}
    bwd = {k: comm.backward_stats[k] - bwd_before[k] for k in bwd_before}
    return {"gathers": fwd["collectives"], "gather_bytes": fwd["bytes"],
            "bwd_gathers": bwd["collectives"], "bwd_bytes": bwd["bytes"]}


def dry_cell(cfg, kind: str, mesh, *, batch: int, seq: int,
             topology: str = "base", k: int = 1, method: str = "dsgdm",
             remat: bool = True, flatten_gossip: bool = False,
             embed_hint: bool = False, append_free: bool = False,
             frames: int = AUDIO_FRAMES,
             param_dtype=torch.bfloat16,
             cache_dtype=torch.bfloat16) -> dict:
    """One rank's step of ``cfg`` on the dry ``mesh`` (``launch.mesh.
    dry_mesh``) for a ``kind`` ("train", "prefill" or "decode") shape of
    ``batch`` sequences (the whole mesh's) of ``seq`` positions: the
    cell's numbers (module docstring).  A decode step writes the cache's
    last position; an audio model's encoder takes ``frames`` frames (the
    shape table's 1024 by default)."""
    world = 1
    for s in mesh.shape.values():
        world *= s
    enc_T = float(frames) if cfg.encoder is not None else 0.0
    t = text_len(cfg, seq)
    out = {"ranks": world, "coords": dict(mesh.coords)}
    if kind == "train":
        rules = make_rules(mesh, arch_name=cfg.name, context="train")
        bundle = make_train_step(cfg, mesh=mesh, topology=topology, k=k,
                                 method_name=method, param_dtype=param_dtype,
                                 remat=remat, flatten_gossip=flatten_gossip,
                                 embed_lookup_replicated=embed_hint)
        n = bundle.n_nodes
        params = _meta_shards(cfg, rules, mesh, param_dtype, lead=(1,))
        opt = bundle.method.init(params)
        b = _frames(train_batch_shapes(cfg, n, seq=seq, global_batch=batch,
                                       dtype=param_dtype), frames)
        node_batch = {key: v[bundle.node:bundle.node + 1]
                      for key, v in b.items()}
        rows = local_rows(rules, batch // n)[1]
        comm = bundle.model.tp
        before, bwd = dict(comm.stats), dict(comm.backward_stats)
        sent = bundle.mixer.stats["bytes"]
        new, _, loss = bundle.step_fn(params, opt, node_batch, 0)
        if tuple(loss.shape) != () or any(
                new[key].shape != v.shape for key, v in params.items()):
            raise RuntimeError("the dry step's loss or parameters are off")
        flops = train_flops(cfg, global_batch=batch, seq=seq, remat=remat,
                            enc_T=enc_T, text_T=t).flops
        mem = {"params": _nbytes(params), "opt_state": _nbytes(opt),
               # autograd's gradients: one per parameter, its shape
               # and dtype
               "grads": _nbytes(params),
               "batch": _nbytes(node_batch) * rows // (batch // n),
               "cache": 0}
        out.update(_gathers(comm, before, bwd))
        out.update(n_nodes=n, node=bundle.node, n_rounds=bundle.n_rounds,
                   gossip_axis=rules.node_axis, rows=rows,
                   spec=bundle.spec.to_dict() if bundle.spec else None,
                   gossip_bytes=bundle.mixer.stats["bytes"] - sent,
                   model_flops=model_flops(cfg, kind="train",
                                           global_batch=batch, seq=seq,
                                           text_T=t))
    else:
        rules = make_rules(mesh, arch_name=cfg.name, context="serve")
        model = bind(cfg, _meta_shards(cfg, rules, mesh, param_dtype), mesh)
        row0, rows = local_rows(rules, batch)
        comm = model.tp
        with torch.inference_mode():
            if kind == "prefill":
                pre = make_prefill(cfg, mesh, batch=batch, seq=seq,
                                   param_dtype=param_dtype,
                                   cache_dtype=cache_dtype)
                inputs = _frames(prefill_batch_shapes(
                    cfg, batch=rows, seq=seq, dtype=param_dtype), frames)
                before, bwd = dict(comm.stats), dict(comm.backward_stats)
                logits, cache, enc = pre.fn(model, inputs)
                flops = forward_flops(cfg, batch=batch, T=t,
                                      enc_T=enc_T).flops
                batch_bytes = _nbytes(inputs)
            else:
                cache, tokens, _, enc = decode_inputs(
                    cfg, batch=rows, seq=seq, cache_dtype=cache_dtype)
                if enc is not None:
                    enc = _frames({"frames": enc}, frames)["frames"]
                dec = make_decode_step(cfg, mesh, batch=batch, seq=seq,
                                       param_dtype=param_dtype,
                                       append_free=append_free)
                before, bwd = dict(comm.stats), dict(comm.backward_stats)
                logits, cache = dec.fn(model, cache, tokens, seq - 1,
                                       *(() if enc is None else (enc,)))
                flops = forward_flops(cfg, batch=batch, T=1, S=seq,
                                      decode=True).flops
                batch_bytes = _nbytes(tokens)
        if logits.shape[0] != rows:
            raise RuntimeError(f"the dry step's logits {tuple(logits.shape)}"
                               f" are not the rank's {rows} rows")
        mem = {"params": _nbytes(dict(model.named_parameters())),
               "opt_state": 0, "grads": 0, "batch": batch_bytes,
               "cache": _nbytes(cache) + _nbytes(enc)}
        out.update(_gathers(comm, before, bwd))
        out.update(row0=row0, rows=rows, model_flops=model_flops(
            cfg, kind=kind, global_batch=batch, seq=seq, text_T=t))
    total = sum(mem.values())
    out.update(
        memory=dict(mem, total=total), fits=total <= HBM_BYTES,
        hbm_bytes=HBM_BYTES, flops=flops, flops_per_rank=flops / world,
        compute_s=flops / world / PEAK_FLOPS_BF16,
        hbm_s=total / HBM_BW)
    return out


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool,
               topology: str = "base", k: int = 1,
               method: str = "dsgdm", flatten_gossip: bool = False,
               append_free: bool = False, embed_hint: bool = False) -> dict:
    """One cell of the production sweep: rank 0 of the 16x16 (or
    2x16x16) mesh at the shape's global batch and length."""
    cfg0 = get_config(arch)
    mesh_name = "multi" if multi_pod else "single"
    reason = skip_reason(cfg0, shape_name)
    if reason:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}
    cfg = config_for_shape(cfg0, shape_name)
    info = INPUT_SHAPES[shape_name]
    mesh = dry_mesh(make_production_mesh(multi_pod=multi_pod))
    t0 = time.time()
    res = dry_cell(cfg, info["kind"], mesh, batch=info["global_batch"],
                   seq=info["seq"], topology=topology, k=k, method=method,
                   flatten_gossip=flatten_gossip, embed_hint=embed_hint,
                   append_free=append_free)
    return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "status": "ok", "topology": topology, "k": k,
            "run_s": round(time.time() - t0, 1), **res}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--topology", default="base",
                    help="registered topology name or inline JSON "
                         "TopologySpec (n is filled from the mesh)")
    ap.add_argument("--k", type=int, default=1)
    ap.add_argument("--method", default="dsgdm")
    ap.add_argument("--flatten-gossip", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a process of its own "
                         "(one torch thread each)")
    args = ap.parse_args(argv)

    archs = ARCH_NAMES if args.all or not args.arch else [args.arch]
    shapes = list(INPUT_SHAPES) if args.all or not args.shape \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)

    # filename-safe topology token, as the reference's: an inline JSON
    # spec hashes its normalised form and already carries k
    if args.topology.strip().startswith("{"):
        norm = json.dumps(json.loads(args.topology), sort_keys=True,
                          separators=(",", ":"))
        topo_tag = "spec" + hashlib.sha256(norm.encode()).hexdigest()[:8]
        topo_suffix = f"_{topo_tag}"
    else:
        topo_tag = args.topology
        topo_suffix = f"_{topo_tag}k{args.k}"
    todo = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape}_{'multi' if mp else 'single'}"
                if topo_tag != "base" or args.flatten_gossip:
                    tag += topo_suffix + \
                        ("_flat" if args.flatten_gossip else "")
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[skip existing] {tag}")
                    continue
                todo.append((tag, path, (arch, shape, mp, args.topology,
                                         args.k, args.method,
                                         args.flatten_gossip)))
    if args.jobs > 1:
        # the SSM archs' chunked scans take longest on meta: start first
        todo.sort(key=lambda c: get_config(c[2][0]).ssm is None)
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(args.jobs, mp_context=ctx) as pool:
            futs = {pool.submit(_cell, *cell): (tag, path)
                    for tag, path, cell in todo}
            for fut in as_completed(futs):
                _report(*futs[fut], fut.result())
    else:
        for tag, path, cell in todo:
            _report(tag, path, _cell(*cell))


def _cell(arch, shape, mp, topology, k, method, flatten_gossip) -> dict:
    """One cell's result, or its ``status: error`` and traceback."""
    if multiprocessing.parent_process() is not None:
        torch.set_num_threads(1)
    try:
        return dryrun_one(arch, shape, multi_pod=mp, topology=topology, k=k,
                          method=method, flatten_gossip=flatten_gossip)
    except Exception:
        return {"arch": arch, "shape": shape,
                "mesh": "multi" if mp else "single", "status": "error",
                "traceback": traceback.format_exc()}


def _report(tag: str, path: str, res: dict) -> None:
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    print(f"[{res['status']}] {tag} "
          f"flops/rank={res.get('flops_per_rank', 0):.3e} "
          f"gathers={res.get('gathers', 0)} "
          f"bytes/rank={res.get('memory', {}).get('total', 0)} "
          f"run={res.get('run_s', 0)}s", flush=True)

if __name__ == "__main__":
    main()
