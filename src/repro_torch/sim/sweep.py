"""Multi-config sweeps over the simulation engine (port of
``repro/sim/sweep.py``).

The paper's headline results (Figs. 1/5/7-9, Tables 1-2) compare runs
*across* topologies, degrees and seeds.  The reference vmaps its
single-run ``lax.scan`` over configs x seeds and jits the grid once.
The port runs the grid as one step loop over stacked copies
(:func:`repro_torch.sim.engine.run_copies`):

* every schedule's round-robin period is stacked to a common-length
  ``(C, Lmax, n, n)`` tensor with per-config round indices (padding is
  never read: ``idx[c, t] = t % L_c``);
* the C x S copies of the node-stacked model live in one set of
  ``(C * S * n, ...)`` tensors, copy ``c * S + s``;
* each step's elementwise update runs over every copy at once (on the
  card, DSGD-momentum is one grouped launch of the fused kernel per
  dtype, its pre-scale each copy's own ``diag(W_c)``; a compressed
  method quantizes every copy's reference leaves in one bucketed call,
  each copy's records from row offset 0), while the gradients, mixes,
  eval and consensus error run copy by copy through the calls a single
  run makes.

So every cell equals its own :func:`simulate_decentralized` run bit for
bit, on the CPU and on the card, with or without a failure model (every
cell sees the same failure trace: common random numbers for paired
topology comparisons).  All configs in one sweep share the method,
batches, eta and eval_fn.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.optim.decentralized import Method
from repro_torch.topology import as_schedule

from .engine import (SimResult, check_failure_method, node_stack,
                     run_copies)
from .failure import FailureModel


@dataclass
class SweepResult:
    """Grid of runs: axis 0 = schedule/config, axis 1 = seed."""
    names: list[str]
    losses: np.ndarray          # (C, S, steps)
    test_acc: np.ndarray        # (C, S, evals)
    consensus: np.ndarray       # (C, S, evals)
    eval_steps: np.ndarray      # (evals,)
    clocks: np.ndarray | None = None   # (C, S, n) failure-model runs only
    # the final parameters of every copy, (C * S * n, ...) per tensor
    params: dict | None = None

    def run(self, config: int, seed: int = 0) -> SimResult:
        """A single (config, seed) cell, as a plain SimResult (with its
        copy's final (n, ...) parameters)."""
        params = None
        if self.params is not None:
            S = self.losses.shape[1]
            n = next(iter(self.params.values())).shape[0] \
                // (self.losses.shape[0] * S)
            g = config * S + seed
            params = {k: x[g * n:(g + 1) * n]
                      for k, x in self.params.items()}
        return SimResult(self.losses[config, seed],
                         self.test_acc[config, seed],
                         self.consensus[config, seed], self.eval_steps,
                         params=params,
                         clocks=None if self.clocks is None
                         else self.clocks[config, seed])


def stack_schedules(schedules: Sequence, steps: int, device=None):
    """Pad + stack the schedules' periods into ``(C, Lmax, n, n)`` and
    build the ``(C, steps)`` per-step round indices, on ``device`` (CUDA
    unless asked).  Each schedule's stack comes from
    ``Schedule.as_padded`` (float32, identity padding, memoized per
    device and length), so sweep cells stay bit-exact with single runs;
    padding rounds are never indexed (``idx[c, t] = t % L_c < L_c``)."""
    dev = resolve_device(device)
    scheds = [as_schedule(s) for s in schedules]
    n = scheds[0].n
    if any(s.n != n for s in scheds):
        raise ValueError("all schedules in one sweep must share n")
    Lmax = max(max(1, len(s)) for s in scheds)
    per = [s.as_padded(steps, Lmax, dev) for s in scheds]
    return (torch.stack([W for W, _ in per]),
            torch.stack([i for _, i in per]))


def sweep_decentralized(
        *, loss_fn: Callable, params, method: Method,
        schedules: Sequence, batches: Callable, steps: int, eta: float,
        eval_fn: Callable | None = None, eval_every: int = 50,
        failure: FailureModel | None = None, device=None) -> SweepResult:
    """Run ``len(schedules) x n_seeds`` independent simulations as one
    step loop over stacked copies (see the module's docstring).

    ``params`` is either one model's flat dict (one seed) or a list or
    tuple of them (one per seed).  Results match per-cell
    ``simulate_decentralized`` runs bit for bit, including under a
    ``failure`` model (same model per cell, shared trace).  Runs on
    ``device`` (CUDA unless asked)."""
    if failure is not None:
        check_failure_method(failure, method)
    dev = resolve_device(device)
    schedules = [as_schedule(s) for s in schedules]
    params_list = list(params) if isinstance(params, (list, tuple)) \
        else [params]
    names = [s.label for s in schedules]
    if steps <= 0:
        shape = (len(schedules), len(params_list), 0)
        empty = np.zeros(shape, np.float32)
        return SweepResult(names, empty, empty.copy(), empty.copy(),
                           np.asarray([], np.int64))
    Ws, idx = stack_schedules(schedules, steps, dev)
    n, S = schedules[0].n, len(params_list)
    stacked = [node_stack(p, n, dev) for p in params_list]
    params_n = {k: torch.cat([stacked[s][k] for _ in schedules
                              for s in range(S)]) for k in stacked[0]}
    del stacked
    losses, accs, cons, evs, clocks, params_n, _ = run_copies(
        loss_fn=loss_fn, params_n=params_n, method=method, Ws=Ws, idx=idx,
        seeds=S, batches=batches, steps=steps, eta=eta, eval_fn=eval_fn,
        eval_every=eval_every, failure=failure, dev=dev)
    C = len(schedules)
    if clocks is not None:
        clocks = np.broadcast_to(clocks, (C, S, n)).copy()
    return SweepResult(names, losses.reshape(C, S, -1),
                       accs.reshape(C, S, -1), cons.reshape(C, S, -1), evs,
                       clocks, params_n)
