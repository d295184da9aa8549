"""Rank functions for ``tests/test_torch_checkpoint.py`` and
``tests/test_torch_overlap.py``.

``launch.distributed.spawn_local`` pickles a rank function by name, and
each rank imports its module afresh, so these live in a module of their
own that imports no JAX.  Each returns numpy arrays (bf16 as its uint16
bits), so the parent can hold them against the reference.
"""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import AsyncCheckpointer, load_pytree, \
    save_pytree
from repro_torch.configs import get_config
from repro_torch.dist.steps import make_train_step
from repro_torch.launch.train import (TrainOptions, node_mean, rank_batch,
                                      train_rank)
from repro_torch.models import model as M
from repro_torch.sim.engine import node_stack


def numpy_bits(tree):
    """A flat dict (or a state of flat dicts and ints) as numpy, bf16 as
    its uint16 bits."""
    if isinstance(tree, dict):
        return {k: numpy_bits(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return tree


def _bf16_slice(bits: np.ndarray, rank: int) -> torch.Tensor:
    return torch.from_numpy(
        bits[rank:rank + 1].view(np.int16).copy()).view(torch.bfloat16)


def write_bf16(rank, device, ckpt_dir, params_bits, u_bits, step):
    """Rank ``rank``'s (1, ...) slices of node-stacked bf16 parameters and
    momentum (as uint16 bits), saved under "latest" with one shard file
    per rank; then their node-mean, saved by rank 0 under "ckpt", as the
    launcher does.  Returns this rank's save records."""
    torch.set_num_threads(1)
    params = {k: _bf16_slice(v, rank).to(device)
              for k, v in params_bits.items()}
    u = {k: _bf16_slice(v, rank).to(device) for k, v in u_bits.items()}
    ckpt = AsyncCheckpointer(ckpt_dir)
    ckpt.save({"params": params, "opt": {"u": u}, "step": step},
              name="latest")
    ckpt.close()
    avg = node_mean(params)
    if rank == 0:
        save_pytree(avg, ckpt_dir)
    return ckpt.stats


def resume(rank, device, opts: TrainOptions):
    """The launcher's run (``train_rank``, saving "latest" on its
    schedule), then a resume: fresh templates (other parameters, a zero
    state) loaded from "latest" at this rank's rows, and the remaining
    steps through a new step bundle.  Returns both runs' parameters,
    states and losses."""
    torch.set_num_threads(1)
    res = train_rank(opts, device)
    n = dist.get_world_size()
    cfg = get_config(opts.arch).reduced()
    bundle = make_train_step(cfg, None, topology=opts.topology, k=opts.k,
                             method_name=opts.method, eta=opts.eta,
                             param_dtype=torch.float32, remat=opts.remat,
                             compression=opts.compress)
    fresh = node_stack(M.init(cfg, seed=1, dtype=torch.float32,
                              device=device).state_dict(), 1, device)
    got = load_pytree({"params": fresh, "opt": bundle.method.init(fresh),
                       "step": 0}, opts.ckpt_dir, "latest", rank=rank)
    params, opt = got["params"], got["opt"]
    loaded_ct = opt.get("ct")
    losses = []
    for step in range(got["step"] + 1, opts.steps):
        params, opt, loss = bundle.step_fn(
            params, opt, rank_batch(cfg, opts, step, n, rank, device), step)
        losses.append(float(loss))
    return {"step": got["step"], "loaded_ct": loaded_ct,
            "uninterrupted": {"params": numpy_bits(res.params),
                              "state": numpy_bits(res.state),
                              "losses": res.losses},
            "resumed": {"params": numpy_bits(params),
                        "state": numpy_bits(opt), "losses": losses},
            "saves": res.checkpoints}


def checkpoint_cases(rank, device, ckpt_dirs, params_bits, u_bits, step,
                     resume_opts):
    """Every distributed case of the checkpoint tests in one spawn."""
    out = {"write": write_bf16(rank, device, ckpt_dirs[0], params_bits,
                               u_bits, step)}
    for name, opts in resume_opts:
        out[name] = resume(rank, device, opts)
    return out


def overlap_cases(rank, device, params_np, cases, steps, eta, seq, b):
    """For each ``(method, flatten, overlap)``, this rank's node of reduced
    gemma3-1b with two pattern blocks (f32) over Base-2 for ``steps``
    steps from the given parameters: final parameters, state, losses and
    what its mixer sent."""
    torch.set_num_threads(1)
    cfg = get_config("gemma3-1b").reduced(num_blocks=2)
    n = dist.get_world_size()
    opts = TrainOptions(reduced=True, batch=n * b, seq=seq)
    out = {}
    for method, flatten, overlap in cases:
        params = node_stack({k: torch.from_numpy(v) for k, v in
                             params_np.items()}, 1, device)
        bundle = make_train_step(cfg, None, topology="base", k=1,
                                 method_name=method, eta=eta,
                                 param_dtype=torch.float32, remat=False,
                                 flatten_gossip=flatten, overlap=overlap)
        opt = bundle.method.init(params)
        losses = []
        for step in range(steps):
            params, opt, loss = bundle.step_fn(
                params, opt, rank_batch(cfg, opts, step, n, rank, device),
                step)
            losses.append(float(loss))
        out[(method, flatten, overlap)] = {
            "params": numpy_bits(params), "state": numpy_bits(opt),
            "losses": losses, "sent": dict(bundle.mixer.stats),
            "overlap": bundle.overlap}
    return out
