"""Single-device decentralized-training simulation (port of
``repro/sim/engine.py``).

Runs n virtual nodes as the leading axis of node-stacked flat dicts of
tensors.  Each step computes per-node gradients on per-node data,
applies the decentralized method's update, and mixes with the round's
matrix ``W(r)`` (dense ``W @ X``, the numerical ground truth of the
distributed runtime).  Reproduces the paper's Sec. 6.2 experiments.

The reference has two backends over the same math, a ``lax.scan`` and a
per-step Python loop, which agree bit for bit (tests/test_sim_scan.py).
PyTorch runs eagerly, so the port has one per-step loop and accepts
either name for it.  Per-node gradients come from a loop over nodes:
each node's slice of the stacked parameters is a leaf of its own, and
``torch.autograd.grad`` differentiates the caller's
``loss_fn(params, batch)`` at it.  The step's loss is the mean over
nodes, as the reference's ``_make_train_step`` (:121-129) gives it.
Losses stay on the device until the run ends, so a step does not wait
for the host.  A compressed method's state (the step counter ``ct`` and
the EF21 residuals ``ef``) rides through the loop like any other state.

The failure-realistic backend (``failure=``) is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch import trace
from repro_torch.device import resolve_device
from repro_torch.optim.decentralized import Method
from repro_torch.topology import as_schedule


@dataclass
class SimResult:
    losses: np.ndarray          # (steps,) mean node training loss
    test_acc: np.ndarray        # (evals,) accuracy of the averaged model
    consensus: np.ndarray       # (evals,) mean param variance across nodes
    eval_steps: np.ndarray
    # the final node-stacked parameters and method state (the reference's
    # engine does not return them; the port's parity tests and chip check
    # read them)
    params: dict | None = None
    state: dict | None = None


def _consensus_error(params_n: dict) -> torch.Tensor:
    """Mean squared distance of the nodes' parameters from their average,
    per parameter element, in f32 (bf16 leaves are widened first)."""
    tot = 0.0
    cnt = 0
    for x in params_n.values():
        xf = x.float()
        tot = tot + ((xf - xf.mean(dim=0, keepdim=True)) ** 2).sum()
        cnt += x[0].numel()
    return tot / cnt


def node_stack(params: dict, n: int, device=None) -> dict:
    """Broadcast one model's flat dict of tensors to the node-stacked
    layout: n contiguous copies on ``device`` (CUDA unless asked)."""
    dev = resolve_device(device)
    out = {}
    for k, p in params.items():
        p = p.detach().to(dev)
        out[k] = p.unsqueeze(0).expand((n,) + p.shape).contiguous()
    return out


def eval_mask(steps: int, eval_every: int) -> np.ndarray:
    """Boolean step mask of the eval points:
    ``r % eval_every == 0 or r == steps - 1``."""
    m = np.arange(steps) % max(1, eval_every) == 0
    m[-1] = True
    return m


def _map(fn, batch):
    """``fn`` applied to every array of a batch (an array, or a dict,
    tuple or list of them)."""
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(fn, v) for v in batch)
    return fn(batch)


def node_grads(loss_fn: Callable, params_n: dict, batch):
    """Per-node losses (n,) and node-stacked gradients of
    ``loss_fn(params, batch)``, one node at a time."""
    n = next(iter(params_n.values())).shape[0]
    grads = {k: torch.empty_like(x) for k, x in params_n.items()}
    losses = []
    for i in range(n):
        p_i = {k: x[i].detach().requires_grad_() for k, x in params_n.items()}
        loss = loss_fn(p_i, _map(lambda a: a[i], batch))
        g_i = torch.autograd.grad(loss, list(p_i.values()))
        for buf, g in zip(grads.values(), g_i):
            buf[i].copy_(g)
        losses.append(loss.detach())
    return torch.stack(losses), grads


def simulate_decentralized(
        *, loss_fn: Callable, params, method: Method, schedule,
        batches: Callable, steps: int, eta: float,
        eval_fn: Callable | None = None, eval_every: int = 50,
        backend: str = "scan", failure=None, device=None) -> SimResult:
    """batches(step) -> per-node batch (a tensor, tuple or dict of
    arrays with leading axis n; numpy arrays are moved to the device).

    ``params`` is one model's flat dict of tensors, copied to every
    node.  ``schedule`` is a ``TopologySpec``, ``Schedule`` or
    ``TopologySchedule``.  ``eval_fn(avg_params)`` returns an accuracy;
    at the eval points (every ``eval_every`` steps and the last) the
    result records it with the consensus error.  Runs on ``device``
    (CUDA unless asked)."""
    if backend not in ("scan", "loop"):
        raise ValueError(f"unknown backend {backend!r}")
    if failure is not None:
        raise NotImplementedError(
            "failure models are not ported to repro_torch yet; see "
            "ROADMAP.md")
    dev = resolve_device(device)
    schedule = as_schedule(schedule)
    if steps <= 0:
        empty = np.asarray([], np.float32)
        return SimResult(empty, empty, empty, np.asarray([], np.int64))
    params_n = node_stack(params, schedule.n, dev)
    Ws, _ = schedule.as_dense_stack(steps, dev)
    state = method.init(params_n)
    mask = eval_mask(steps, eval_every)
    losses, accs, cons, evs = [], [], [], []
    for r in range(steps):
        batch = _map(lambda a: torch.as_tensor(a).to(dev), batches(r))
        trace.mark("step")
        node_losses, grads = node_grads(loss_fn, params_n, batch)
        trace.mark("update")
        with torch.no_grad():
            params_n, state = method.step(params_n, grads, state,
                                          Ws[r % Ws.shape[0]], eta)
        trace.mark("end")
        del grads
        losses.append(node_losses.mean())
        if eval_fn is not None and mask[r]:
            with torch.no_grad():
                avg = {k: x.mean(dim=0) for k, x in params_n.items()}
                accs.append(float(eval_fn(avg)))
                cons.append(float(_consensus_error(params_n)))
            evs.append(r)
    return SimResult(torch.stack(losses).float().cpu().numpy(),
                     np.asarray(accs, np.float32),
                     np.asarray(cons, np.float32), np.asarray(evs, np.int64),
                     params_n, state)
