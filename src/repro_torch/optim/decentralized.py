"""Decentralized learning methods over a topology schedule (port of
``repro/optim/decentralized.py``).

All methods share one interface and operate on *node-stacked* flat dicts
of tensors (every tensor has a leading axis of size n, the virtual
nodes of the simulation engine):

    method = make_method("dsgdm", momentum=0.9)
    state  = method.init(params_n)
    params_n, state = method.step(params_n, grads_n, state, W, eta)

``W`` is the round's (n, n) mixing matrix (a tensor on the params'
device), applied as the dense ``W @ X`` by :func:`mix`; a tree -> tree
callable is accepted too.  A (G, n, n) stack drives G independent
copies of the n nodes at once (the sweep's layout: every tensor
(G * n, ...)): the elementwise updates run over all copies together, on
the card one grouped launch, and each copy mixes with its own matrix.  The state is a dict of node-stacked flat
dicts (``{"u": {...}}``).  Each step returns new tensors; nothing is
updated in place, with one exception: a compressed step writes the new
EF21 residual into the state's ``ef`` tensors (see below).

Compressed gossip (``repro_torch.compress``, DESIGN.md Sec. 13): pass a
``CompressionConfig`` (or a CLI string such as ``"int8"``) to
:func:`make_method` and the DSGD / DSGD-momentum step mixes quantized
payloads instead, through
:func:`repro_torch.compress.compressed_dense_mix`.  Its state carries
``ct``, the step counter (a host int) that keys the stochastic rounding,
and with error feedback ``ef``, the f32 residuals, updated in place: at
full width the old and the new residual would not fit on the card
together.  A mixing callable takes the 3-argument form
``mixer(tree, ef, ct) -> (mixed, ef')``.

Implemented (paper Sec. 6.2 & Fig. 9):
  * DSGD (+ heavy-ball momentum)       [Lian et al. 2017, Eq. (1)]
  * QG-DSGDm (quasi-global momentum)   [Lin et al. 2021]
  * D^2                                 [Tang et al. 2018]
  * Gradient Tracking                   [Nedic et al. 2017; Pu & Nedic 2021]
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch import trace
from repro_torch.compress import (CompressionConfig, compressed_dense_mix,
                                  init_ef)
from repro_torch.compress import resolve as resolve_compression
from repro_torch.kernels import ops


def copy_slice(tree: dict, g: int, n: int) -> dict:
    """Copy ``g``'s ``(n, ...)`` views of a flat dict whose tensors stack
    several copies of the n nodes along their leading axis."""
    return {k: x[g * n:(g + 1) * n] for k, x in tree.items()}


def mix(W: torch.Tensor, tree: dict) -> dict:
    """x_i' = sum_j W[i, j] x_j applied to every tensor's leading node
    axis, in f32, cast back to each tensor's dtype.

    ``W`` is one round's (n, n) matrix, or a (G, n, n) stack for G
    copies of the n nodes (a sweep, :mod:`repro_torch.sim.sweep`): each
    tensor is then (G * n, ...) and copy g is mixed by ``W[g]`` alone,
    through the call a single run makes, so its bits are that run's."""
    trace.mark("mix")
    if W.ndim == 3:
        n = W.shape[-1]
        parts = [_mix(Wg, copy_slice(tree, g, n)) for g, Wg in enumerate(W)]
        return {k: torch.cat([p[k] for p in parts]) for k in tree}
    return _mix(W, tree)


def _mix(W: torch.Tensor, tree: dict) -> dict:
    Wt = W.float()
    return {k: torch.tensordot(Wt, x.float(), dims=([1], [0])).to(x.dtype)
            for k, x in tree.items()}


@dataclass(frozen=True)
class Method:
    name: str
    init: Callable
    # (params_n, grads_n, state, W | mixer, eta) -> (params_n, state)
    step: Callable
    # How many times ``step`` mixes per call (gradient tracking mixes its
    # tracker and its parameters).
    mixes_per_step: int = 1
    # Gossip payload compression, always the resolved value: None is the
    # uncompressed method (the identity codec resolves to None).  A
    # compressed method carries "ct" (and "ef") in its state.
    compression: CompressionConfig | None = None
    # The step as a generator, for a mixing callable that completes later
    # (``dist.steps``' overlapped step): ``mix_steps(params_n, grads_n,
    # state, eta)`` yields each tree to mix, is sent it mixed, and returns
    # ``(params_n, state)``; ``step`` with a callable runs the same
    # generator (:func:`drive`).  None for the compressed methods, whose
    # mixer takes the EF residuals and the counter too.
    mix_steps: Callable | None = None


def drive(steps, mixer: Callable):
    """Run a :attr:`Method.mix_steps` generator, mixing each tree it
    yields with ``mixer`` at once; returns what the generator returns."""
    try:
        tree = next(steps)
        while True:
            tree = steps.send(mixer(tree))
    except StopIteration as stop:
        return stop.value


def _as_mixer(w_or_fn) -> Callable:
    if callable(w_or_fn):
        return w_or_fn
    return lambda tree: mix(w_or_fn, tree)


def _zeros_like(tree: dict) -> dict:
    return {k: torch.zeros_like(x) for k, x in tree.items()}


# ---------------------------------------------------------------------------
# DSGD (+momentum): x^{r+1} = W (x^r - eta * u^r)     [paper Eq. (1)]
#
# DSGD-momentum has one body, the reference's fused one
# (decentralized.py:146-162), on every device: the update of every tensor
# is one ops.fused_dsgd_steps call (on the card one grouped launch of the
# CUDA kernel per dtype, on the CPU its plain version leaf by leaf).  With
# a dense mixing matrix the per-node self-weight
# d = diag(W) is folded into the update's per-row pre_scale and the mix
# runs with W~[i, j] = W[i, j] / d_j (columns with d_j = 0 are left as
# they are), so W~ @ (d * half) == W @ half up to rounding.  With a
# mixing callable pre_scale stays 1.
#
# Plain DSGD (momentum == 0) keeps the elementwise axpy, as the reference
# does: there is no momentum buffer to fuse.
#
# The compressed step (decentralized.py:177-199) takes the momentum
# half-step through the fused kernel with pre_scale 1 (:164-175): the
# diag(W) fold must not reach the payload, whose bits are those of the
# true half-step values.
# ---------------------------------------------------------------------------

def DSGD(momentum: float = 0.0,
         compression: CompressionConfig | None = None) -> Method:
    ccfg = compression    # resolved by make_method; None == uncompressed

    def init(params_n):
        state = {"u": _zeros_like(params_n)} if momentum else {}
        if ccfg is not None:
            state["ct"] = 0
            if ccfg.error_feedback:
                state["ef"] = init_ef(params_n, ccfg)
        return state

    def half_fused(params_n, grads_n, u_old, eta, pre):
        keys = list(params_n)
        half, u = ops.fused_dsgd_steps(
            [params_n[k] for k in keys], [u_old[k] for k in keys],
            [grads_n[k] for k in keys], momentum, eta, pre)
        return dict(zip(keys, half)), dict(zip(keys, u))

    def steps_plain(params_n, grads_n, state, eta):
        half = {k: x - eta * grads_n[k] for k, x in params_n.items()}
        return (yield half), state

    def step_plain(params_n, grads_n, state, W, eta):
        return drive(steps_plain(params_n, grads_n, state, eta),
                     _as_mixer(W))

    def steps_fused(params_n, grads_n, state, eta):
        half, u = half_fused(params_n, grads_n, state["u"], eta, 1.0)
        return (yield half), {"u": u}

    def step_fused(params_n, grads_n, state, W, eta):
        if callable(W):
            return drive(steps_fused(params_n, grads_n, state, eta), W)
        # (n, n), or (G, n, n) with a pre-scale per copy's row
        d = torch.diagonal(W.float(), dim1=-2, dim2=-1)
        safe = d != 0.0
        pre = torch.where(safe, d, 1.0)
        mixer = _as_mixer(W * torch.where(safe, 1.0 / pre, 1.0).unsqueeze(-2))
        half, u = half_fused(params_n, grads_n, state["u"], eta,
                             pre.reshape(-1))
        return mixer(half), {"u": u}

    def step_compressed(params_n, grads_n, state, W, eta):
        if momentum:
            half, u = half_fused(params_n, grads_n, state["u"], eta, 1.0)
            new_state = {"u": u}
        else:
            half = {k: x - eta * grads_n[k] for k, x in params_n.items()}
            new_state = {}
        ef, ct = state.get("ef"), state["ct"]
        if callable(W):
            mixed, ef = W(half, ef, ct)
        else:
            mixed, ef = compressed_dense_mix(W, half, ef, ccfg, ct)
        new_state["ct"] = ct + 1
        if ccfg.error_feedback:
            new_state["ef"] = ef
        return mixed, new_state

    if ccfg is not None:
        step, steps = step_compressed, None
    elif momentum:
        step, steps = step_fused, steps_fused
    else:
        step, steps = step_plain, steps_plain
    return Method("dsgd" + (f"m{momentum}" if momentum else ""), init, step,
                  compression=ccfg, mix_steps=steps)


# ---------------------------------------------------------------------------
# QG-DSGDm [Lin et al. 2021]: the momentum buffer tracks the *global*
# parameter displacement (x^r - x^{r+1})/eta instead of local gradients,
# which is robust to heterogeneous data.
# ---------------------------------------------------------------------------

def QGDSGDm(momentum: float = 0.9, beta: float = 0.9) -> Method:
    def init(params_n):
        return {"m": _zeros_like(params_n)}

    def steps(params_n, grads_n, state, eta):
        m = state["m"]
        half = {k: x - eta * (grads_n[k] + momentum * m[k])
                for k, x in params_n.items()}
        new = yield half
        # quasi-global momentum: EMA of the realised displacement
        m = {k: beta * m[k] + (1 - beta) * (params_n[k] - new[k]) / eta
             for k in params_n}
        return new, {"m": m}

    def step(params_n, grads_n, state, W, eta):
        return drive(steps(params_n, grads_n, state, eta), _as_mixer(W))

    return Method("qg-dsgdm", init, step, mix_steps=steps)


# ---------------------------------------------------------------------------
# D^2 [Tang et al. 2018]:
#   x^{r+1} = W (2 x^r - x^{r-1} - eta (g^r - g^{r-1}))
#
# As in the reference, D^2 mixes with the lazy W~ = (I + W)/2 by default:
# the textbook update is unstable under time-varying finite-time
# schedules (decentralized.py:241-250).
# ---------------------------------------------------------------------------

def D2(lazy_mixing: bool = True) -> Method:
    def init(params_n):
        # x_prev = params makes the first step plain DSGD: x - eta g
        return {"x_prev": {k: x.clone() for k, x in params_n.items()},
                "g_prev": _zeros_like(params_n)}

    def steps(params_n, grads_n, state, eta):
        xp, gp = state["x_prev"], state["g_prev"]
        corr = {k: 2.0 * x - xp[k] - eta * (grads_n[k] - gp[k])
                for k, x in params_n.items()}
        new = yield corr
        if lazy_mixing:
            new = {k: 0.5 * (a + new[k]) for k, a in corr.items()}
        return new, {"x_prev": params_n, "g_prev": grads_n}

    def step(params_n, grads_n, state, W, eta):
        return drive(steps(params_n, grads_n, state, eta), _as_mixer(W))

    return Method("d2", init, step, mix_steps=steps)


# ---------------------------------------------------------------------------
# Gradient tracking [Nedic et al. 2017]:
#   y^{r+1} = W (y^r + g^r - g^{r-1});   x^{r+1} = W (x^r - eta y^r)
# ---------------------------------------------------------------------------

def GradientTracking() -> Method:
    def init(params_n):
        # y, g_prev = 0 makes the first tracked direction y^1 = W g^0
        return {"y": _zeros_like(params_n), "g_prev": _zeros_like(params_n)}

    def steps(params_n, grads_n, state, eta):
        y, gp = state["y"], state["g_prev"]
        y = yield {k: y[k] + g - gp[k] for k, g in grads_n.items()}
        new = yield {k: x - eta * y[k] for k, x in params_n.items()}
        return new, {"y": y, "g_prev": grads_n}

    def step(params_n, grads_n, state, W, eta):
        return drive(steps(params_n, grads_n, state, eta), _as_mixer(W))

    return Method("gt", init, step, mixes_per_step=2, mix_steps=steps)


METHOD_NAMES = ("dsgd", "dsgdm", "qg-dsgdm", "d2", "gt")


def make_method(name: str, momentum: float = 0.9,
                compression=None) -> Method:
    """The method ``name`` (one of :data:`METHOD_NAMES`).  ``momentum``
    is DSGD-momentum's and QG-DSGDm's beta.

    ``compression`` (a ``CompressionConfig``, a CLI string such as
    ``"int8"``, or None) selects quantized, error-feedback gossip for
    DSGD and DSGD-momentum.  It is resolved first: None, ``"none"``,
    ``""`` and the identity codec all give the uncompressed method."""
    compression = resolve_compression(compression)
    if compression is not None and name not in ("dsgd", "dsgdm"):
        raise ValueError(
            f"gossip compression is implemented for dsgd/dsgdm only; "
            f"{name!r} mixes auxiliary state (momentum/tracker trees) "
            f"whose quantization semantics are not part of this repro")
    if name == "dsgd":
        return DSGD(0.0, compression)
    if name == "dsgdm":
        return DSGD(momentum, compression)
    if name == "qg-dsgdm":
        return QGDSGDm(momentum)
    if name == "d2":
        return D2()
    if name == "gt":
        return GradientTracking()
    raise ValueError(f"unknown method {name!r}")
