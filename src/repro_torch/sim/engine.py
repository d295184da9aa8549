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

``failure=`` selects the failure-realistic step (delayed gossip,
dropout and stragglers, churn, Byzantine nodes; DESIGN.md Sec. 11), the
reference's ``_scan_run_failure`` (``engine.py:228-359``) step by step.
A knob at zero adds nothing to the step, so ``FailureModel()`` equals
``failure=None`` bit for bit.

The loop (:func:`run_copies`) drives G independent copies of the n nodes
at once, every tensor (G * n, ...): a single run is G = 1, and the
multi-config sweep (:mod:`repro_torch.sim.sweep`) stacks its configs and
seeds.  Elementwise work runs over all copies together (on the card the
fused update is one grouped launch per dtype); the mixes, the eval and
the consensus error run copy by copy through the calls a single run
makes, so each copy's bits are its own run's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch import trace
from repro_torch.compress import reference_leaves
from repro_torch.convert import _BLOCKS
from repro_torch.device import resolve_device
from repro_torch.optim.decentralized import Method, copy_slice
from repro_torch.topology import as_schedule

from . import failure as fm
from .failure import (FailureModel, corrupt_visible, effective_W,
                      init_history, participation_mask, select_nodes,
                      stale_visible, write_history)


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
    # final per-node virtual clocks (failure-model runs only): how many
    # rounds each node actually participated in
    clocks: np.ndarray | None = None


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


def materialize_schedule(schedule, steps: int, device=None):
    """One period of the round-robin schedule as a dense ``(L, n, n)``
    float32 tensor plus the per-step round index ``idx[t] = t % L``, on
    ``device`` (CUDA unless asked): ``Schedule.as_dense_stack``, built
    once per topology configuration and device."""
    return as_schedule(schedule).as_dense_stack(steps, device)


def stack_batches(batches: Callable, steps: int, device=None):
    """``batches(0..steps-1)`` stacked along a leading step axis (a
    tensor, or a dict, tuple or list of them), on ``device``."""
    dev = resolve_device(device)
    bs = [batches(r) for r in range(steps)]

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        if isinstance(xs[0], (tuple, list)):
            return type(xs[0])(stack(*parts) for parts in zip(*xs))
        return torch.stack([torch.as_tensor(x) for x in xs]).to(dev)

    return stack(*bs)


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


def check_failure_method(failure: FailureModel, method: Method) -> None:
    """Delay / Byzantine regimes intercept the gossiped values via a
    mixer closure, which only composes with methods that mix exactly
    once per step (gradient tracking mixes twice — its tracker would
    need its own staleness history)."""
    if failure.needs_mixer_closure and method.mixes_per_step != 1:
        raise ValueError(
            f"failure model with delay/Byzantine behaviors requires a "
            f"method that mixes once per step; {method.name!r} declares "
            f"mixes_per_step={method.mixes_per_step}")
    if method.compression is not None:
        raise ValueError(
            "failure models do not compose with compressed gossip: the "
            "failure mixer closures intercept raw trees and know nothing "
            "of the EF residual / payload protocol (DESIGN.md Sec. 13)")


def reference_order(params: dict) -> list[tuple[list[str], bool]]:
    """The reference's leaves of a flat dict, in ``jax.tree.flatten``
    order (dict keys sorted at every level, list items in order): each
    leaf's keys (a pattern block's tensors in block order) and whether
    it is stacked over blocks.  Byzantine noise is drawn per leaf in
    this order, as the reference draws it (``fold_in(key, i)``)."""
    def path(names):
        m = _BLOCKS.match(names[0])
        p = names[0] if m is None else f"{m[1]}.{m[3]}"
        return tuple(int(c) if c.isdigit() else c for c in p.split("."))

    return [(names, _BLOCKS.match(names[0]) is not None)
            for names in sorted(reference_leaves(params), key=path)]


def _leaf_noise(order, noise, mode) -> dict:
    """Per flat key, its slice of its reference leaf's drawn noise."""
    out = {}
    for (names, blocked), leaf in zip(order, noise):
        for b, k in enumerate(names):
            if not blocked:
                out[k] = leaf
            else:
                out[k] = leaf[b] if mode == "all_same" else leaf[:, b]
    return out


def _tile(x: torch.Tensor, G: int) -> torch.Tensor:
    """A per-node tensor repeated for G stacked copies."""
    return x if G == 1 else x.repeat((G,) + (1,) * (x.ndim - 1))


def run_copies(*, loss_fn, params_n: dict, method: Method, Ws, idx,
               seeds: int, batches, steps: int, eta: float, eval_fn,
               eval_every: int, failure: FailureModel | None, dev):
    """The engine's step loop over G = C * seeds copies of n nodes.

    ``params_n``: (G * n, ...) tensors, copy ``g = c * seeds + s``;
    ``Ws``: (C, L, n, n) stacked periods and ``idx``: (C, steps) round
    indices (config c mixes with ``Ws[c, idx[c, t]]``).  Returns
    ``(losses (G, steps), accs (G, evals), cons (G, evals), eval_steps,
    clocks (n,) or None, params_n, state)``; every copy shares one
    failure trace, hence one clock vector."""
    C, n = Ws.shape[0], Ws.shape[-1]
    G = C * seeds
    idx = idx.cpu().tolist()        # the host picks each round's matrix
    state = method.init(params_n)
    mask = eval_mask(steps, eval_every)
    honest = slice(None)
    clock = hist = stragglers = byz = order = None
    if failure is not None:
        stragglers = failure.straggler_mask(n)
        byz_np = failure.byzantine_mask(n)
        if failure.has_byzantine:
            honest = torch.from_numpy(np.nonzero(~byz_np)[0]).to(dev)
            byz = _tile(torch.from_numpy(byz_np).to(dev), G)
        if failure.has_delay:
            hist = init_history(params_n, failure.delay)
        order = reference_order(params_n)
        leaves = [((n, len(names)) + tuple(params_n[names[0]].shape[1:])
                   if blocked else (n,) + tuple(params_n[names[0]].shape[1:]),
                   params_n[names[0]].dtype) for names, blocked in order]
        clock = torch.zeros(n, dtype=torch.int32)
    losses, accs, cons, evs = [], [], [], []
    for t in range(steps):
        batch = _map(lambda a: _tile(torch.as_tensor(a).to(dev), G),
                     batches(t))
        trace.mark("step")
        Wc = [Ws[c, idx[c][t]] for c in range(C)]
        active = None
        if failure is not None:
            dr = fm.draws(failure, t, n, leaves)
            if failure.has_churn:
                # the replacement restarts from the departed node's
                # parameters: fresh optimizer state, clock reset
                churned = _tile(dr.churn.to(dev), G)
                with torch.no_grad():
                    state = select_nodes(churned, method.init(params_n),
                                         state)
                clock = torch.where(dr.churn, 0, clock)
            if failure.has_drop:
                active = participation_mask(failure, dr.keep, t, n,
                                            stragglers)
        node_losses, grads = node_grads(loss_fn, params_n, batch)
        trace.mark("update")
        with torch.no_grad():
            if active is not None:
                # an offline node neither computes nor communicates: zero
                # its gradient and isolate it on the identity row/column
                # of the re-normalized matrix
                off = ~_tile(active.to(dev), G)
                for g in grads.values():
                    g.masked_fill_(off.reshape((-1,) + (1,) * (g.ndim - 1)),
                                   0.0)
                Wc = [effective_W(W, active.to(dev)) for W in Wc]
            Wg = [W for W in Wc for _ in range(seeds)]
            capture: dict = {}
            if failure is not None and failure.needs_mixer_closure:
                slot = noise = None
                if failure.has_delay:
                    tau = dr.tau.to(dev)
                    slot = _tile(torch.where(tau == 0, -1,
                                             (t - tau) % failure.delay), G)
                if dr.noise is not None:
                    noise = {k: (_tile(v.to(dev), G)
                                 if failure.byzantine_mode == "random"
                                 else v.to(dev))
                             for k, v in _leaf_noise(
                                 order, dr.noise,
                                 failure.byzantine_mode).items()}
                w_arg = _failure_mixer(method, failure, Wg, n, hist, slot,
                                       byz, noise, capture)
            else:
                w_arg = Wg[0] if G == 1 else torch.stack(Wg)
            new_params, new_state = method.step(params_n, grads, state,
                                                w_arg, eta)
            del grads
            if failure is not None:
                trace.mark("state")
                if active is not None:
                    # offline nodes' optimizer state is frozen, not decayed
                    new_state = select_nodes(_tile(active.to(dev), G),
                                             new_state, state)
                    clock = clock + active.to(torch.int32)
                else:
                    clock = clock + 1
                if failure.has_delay:
                    write_history(hist, capture.pop("tree"),
                                  t % failure.delay)
            params_n, state = new_params, new_state
        trace.mark("end")
        # each copy's mean over a fresh tensor, as its own run takes it
        losses.append(torch.stack([node_losses[g * n:(g + 1) * n][honest]
                                   .clone().mean() for g in range(G)]))
        if eval_fn is not None and mask[t]:
            with torch.no_grad():
                a, e = [], []
                for g in range(G):
                    sub = {k: x[honest] for k, x in
                           copy_slice(params_n, g, n).items()}
                    avg = {k: x.mean(dim=0) for k, x in sub.items()}
                    a.append(float(eval_fn(avg)))
                    e.append(float(_consensus_error(sub)))
            accs.append(a)
            cons.append(e)
            evs.append(t)
    return (torch.stack(losses, dim=1).float().cpu().numpy(),
            np.asarray(accs, np.float32).reshape(-1, G).T,
            np.asarray(cons, np.float32).reshape(-1, G).T,
            np.asarray(evs, np.int64),
            None if clock is None else clock.numpy(), params_n, state)


def _failure_mixer(method, failure, Wg, n, hist, slot, byz, noise,
                   capture):
    """The closure handed to the method in place of the dense matrices
    (the reference's ``make_mixer``, ``engine.py:258-288``): it keeps
    the gossiped tree for the history write, swaps in stale / corrupted
    neighbor values, and mixes in f32 with the self-weight on the node's
    own CURRENT value.  Tensor by tensor, so one tensor's f32
    temporaries are alive at a time."""
    Wt = [W.float() for W in Wg]
    Wd = [torch.diagonal(W) for W in Wt]
    Woff = [W - torch.diag(d) for W, d in zip(Wt, Wd)]

    def mixer(tree):
        if "tree" in capture:
            raise RuntimeError(
                f"method {method.name!r} mixed more than once per step; "
                f"unsupported under delay/Byzantine failure")
        capture["tree"] = tree
        out = {}
        for k, x in tree.items():
            v = {k: x}
            if failure.has_delay:
                trace.mark("stale")
                v = stale_visible(v, {k: hist[k]}, slot)
            if failure.has_byzantine:
                trace.mark("corrupt")
                v = corrupt_visible(failure, v, byz,
                                    None if noise is None else {k: noise[k]})
            trace.mark("mix")
            v = v[k]
            parts = []
            for g in range(len(Wt)):
                sl = slice(g * n, (g + 1) * n)
                o = torch.tensordot(Woff[g], v[sl].float(), dims=([1], [0]))
                own = x[sl].to(torch.float32, copy=True)
                own *= Wd[g].reshape((-1,) + (1,) * (x.ndim - 1))
                o += own
                del own
                parts.append(o.to(x.dtype))
                del o
            out[k] = parts[0] if len(parts) == 1 else torch.cat(parts)
            del v, parts
        return out

    return mixer


def simulate_decentralized(
        *, loss_fn: Callable, params, method: Method, schedule,
        batches: Callable, steps: int, eta: float,
        eval_fn: Callable | None = None, eval_every: int = 50,
        same_init: bool = True, key=None, backend: str = "scan",
        failure: FailureModel | None = None, device=None) -> SimResult:
    """batches(step) -> per-node batch (a tensor, tuple or dict of
    arrays with leading axis n; numpy arrays are moved to the device).

    ``params`` is one model's flat dict of tensors, copied to every
    node.  ``schedule`` is a ``TopologySpec``, ``Schedule`` or
    ``TopologySchedule``.  ``eval_fn(avg_params)`` returns an accuracy;
    at the eval points (every ``eval_every`` steps and the last) the
    result records it with the consensus error.  ``failure`` selects the
    failure-realistic step (see the module's docstring); under Byzantine
    nodes the loss, eval and consensus cover the honest nodes only.
    ``same_init`` and ``key`` are the reference's keywords, unused there
    too.  Runs on ``device`` (CUDA unless asked)."""
    del same_init, key
    if backend not in ("scan", "loop"):
        raise ValueError(f"unknown backend {backend!r}")
    if failure is not None and backend != "scan":
        raise ValueError("failure models require the scan backend")
    if failure is not None:
        check_failure_method(failure, method)
    dev = resolve_device(device)
    schedule = as_schedule(schedule)
    if steps <= 0:
        empty = np.asarray([], np.float32)
        return SimResult(empty, empty, empty, np.asarray([], np.int64))
    Ws, idx = materialize_schedule(schedule, steps, dev)
    losses, accs, cons, evs, clocks, params_n, state = run_copies(
        loss_fn=loss_fn, params_n=node_stack(params, schedule.n, dev),
        method=method, Ws=Ws[None], idx=idx[None], seeds=1,
        batches=batches, steps=steps, eta=eta, eval_fn=eval_fn,
        eval_every=eval_every, failure=failure, dev=dev)
    return SimResult(losses[0], accs[0], cons[0], evs, params_n, state,
                     clocks)
