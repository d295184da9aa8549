"""Mixture-of-Experts layer (port of ``repro/models/moe.py``; grok-1 and
deepseek-v3 styles).

Dispatch is capacity-based per-expert gather, as the reference's
``moe_apply`` (``moe.py:55-98``): each token routes to its top-k experts
by an f32 router's softmax; each expert then takes its top-C assigned
tokens (``C = min(N, max(1, int(N·K·cf / E)))``), gathers them, runs its
gated FFN as batched products over the expert axis (``torch.bmm``: plain
products, outside any kernel) and adds the gated outputs back.  The
Switch-style load-balance loss and the always-on shared experts
(deepseek: 1 shared + 256 routed) are the reference's.

What the port must do on its own to give the reference's answers:

* **Ties.**  ``jax.lax.top_k`` puts the lower index first among equal
  values; ``torch.topk`` promises no order.  Ties are common here: every
  expert's row of ``sel.T`` holds zeros, and identical tokens score
  alike.  :func:`top_k` is a stable descending sort, sliced, for both
  top-k's (the router's and the capacity's).  The gradient flows through
  the sorted values, as JAX's ``top_k`` JVP; the indices carry none.
* **A deterministic combine.**  The reference scatter-adds the E·C gated
  rows into zeros, one row after another in expert-major order.  A token
  takes at most K non-zero terms (its chosen experts); the rest of its
  terms are zeros from unchosen experts' empty slots.  :func:`combine`
  builds an (N, K) table of each token's rows in ascending expert order
  (a zero row for a dropped slot) and adds the K terms in that order, in
  the activations' dtype, from zero: K gathers and adds, the sequential
  scatter's sums, and the same bits on every run (``index_add_`` on CUDA
  adds through atomics, in an order that changes from run to run).
* **Capacity depends on N.**  Decode at B = 4 gives C = 1 for grok and
  deepseek, a speculative verify window routes B·(k+1) tokens at once,
  and continuous serving routes its free slots' dummy tokens and
  right-padded prefill rows with the rest.  The port follows the
  reference in all three (ROADMAP.md, queue 3).

The gather, the expert products and the gate scaling are the span
``"moe.experts"`` of :mod:`repro_torch.trace`, with its device time.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import trace
from repro_torch.configs.common import MoEConfig

from .layers import MLP, normal_


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values and their
    indices, the lower index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Slots per expert: ``min(N, max(1, int(N·K·cf / E)))``."""
    c = max(1, int(n_tokens * cfg.top_k * cfg.capacity_factor
                   / cfg.num_experts))
    return min(c, n_tokens)


class Routing(NamedTuple):
    """One layer's routing of N tokens over E experts of C slots."""
    probs: torch.Tensor         # (N, E) f32 router softmax
    gate_vals: torch.Tensor     # (N, K) f32, normalised if configured
    gate_idx: torch.Tensor      # (N, K) chosen experts, best first
    top_scores: torch.Tensor    # (E, C) f32 gate of each slot's token
    top_tok: torch.Tensor       # (E, C) token of each slot
    keep: torch.Tensor          # (E, C) slot holds a chosen token


def route(xf: torch.Tensor, router: torch.Tensor, cfg: MoEConfig) -> Routing:
    """The reference's routing (``moe.py:62-79``): xf (N, D), router
    (D, E)."""
    N, E, K = xf.shape[0], cfg.num_experts, cfg.top_k
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, K)
    if cfg.normalize_gates:
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(
            1e-9)
    # scores restricted to the chosen experts (0 elsewhere)
    sel = torch.zeros(N, E, dtype=torch.float32, device=xf.device).scatter(
        1, gate_idx, gate_vals)
    top_scores, top_tok = top_k(sel.T, capacity(N, cfg))
    return Routing(probs, gate_vals, gate_idx, top_scores, top_tok,
                   top_scores > 0.0)


def combine_table(r: Routing) -> torch.Tensor:
    """(N, K) rows of each token's gated outputs in ``ye.reshape(E*C, D)``,
    in ascending expert order; row ``E*C`` (a zero row) for a chosen
    expert whose slots dropped the token."""
    E, C = r.top_tok.shape
    N = r.gate_idx.shape[0]
    dev = r.top_tok.device
    zero = E * C
    rows = torch.arange(zero, device=dev).reshape(E, C)
    slot = torch.full((E, N), zero, dtype=torch.int64, device=dev)
    # an expert's C tokens are distinct, so no two writes meet
    slot.scatter_(1, r.top_tok, torch.where(r.keep, rows, zero))
    experts = torch.sort(r.gate_idx, dim=1).values
    return slot[experts, torch.arange(N, device=dev)[:, None]]


def combine(ye: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``sum_j ye[table[:, j]]`` for (E, C, D) gated rows: the K terms of
    each token added in table order, in ``ye``'s dtype, from zero."""
    E, C, D = ye.shape
    rows = torch.cat([ye.reshape(E * C, D), ye.new_zeros(1, D)])
    y = ye.new_zeros(table.shape[0], D)
    for j in range(table.shape[1]):
        y = y + rows[table[:, j]]
    return y


def _act(h: torch.Tensor, act: str) -> torch.Tensor:
    return F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")


class MoE(nn.Module):
    """``moe_init`` / ``moe_apply``.  Parameter names are the reference's
    leaves: ``router`` (D, E), ``w_gate`` and ``w_up`` (E, D, F),
    ``w_down`` (E, F, D), and ``shared_<s>`` gated MLPs of width F.  On a
    tensor-parallel rank (``tp`` set, ``repro_torch.dist.tp``) the four
    are gathered whole where they are used."""

    tp = None

    def __init__(self, d_model: int, cfg: MoEConfig, *, act: str, dtype,
                 device):
        super().__init__()
        self.cfg, self.act = cfg, act
        E, Fe = cfg.num_experts, cfg.d_expert

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)

        self.router = param(d_model, E)
        self.w_gate = param(E, d_model, Fe)
        self.w_up = param(E, d_model, Fe)
        self.w_down = param(E, Fe, d_model)
        for s in range(cfg.num_shared):
            setattr(self, f"shared_{s}", MLP(d_model, Fe, act=act,
                                             dtype=dtype, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.router, generator)
        # one expert at a time: the f32 draw of a whole (E, D, F) tensor
        # would take twice its bf16 size again (deepseek-v3's w_gate alone
        # is 7.5 GB in bf16)
        for w in (self.w_gate, self.w_up, self.w_down):
            for e in range(w.shape[0]):
                normal_(w[e], generator)

    def forward(self, x):
        """x: (B, T, D) -> (y (B, T, D) in x's dtype, f32 aux loss).  On a
        tensor-parallel rank whose batch rows are split
        (``tp.comm.row_axes``) the routed experts take the node's whole
        batch, its rows gathered before the router and the routed output
        split back: one capacity and one aux loss for the node, as the
        reference's step routes it; the shared experts take the rank's
        rows."""
        cfg = self.cfg
        rows = self.tp is not None and bool(self.tp.comm.row_axes)
        x_own = x
        if rows:
            x = self.tp.comm.cat_rows(x)
        B, T, D = x.shape
        N, E, K = B * T, cfg.num_experts, cfg.top_k
        xf = x.reshape(N, D)
        router, w_gate, w_up, w_down = (
            getattr(self, n) if self.tp is None
            else self.tp.whole(self, n, whole_batch=rows)
            for n in ("router", "w_gate", "w_up", "w_down"))
        r = route(xf, router, cfg)
        with trace.span("moe.experts", device=xf.is_cuda):
            xe = xf[r.top_tok]                                 # (E, C, D)
            h = _act(torch.bmm(xe, w_gate), self.act) * torch.bmm(xe, w_up)
            ye = torch.bmm(h, w_down)
            ye = ye * (r.top_scores * r.keep)[..., None].to(ye.dtype)
        y = combine(ye, combine_table(r))
        if rows:
            y = self.tp.comm.split_rows(y.reshape(B, T, D)).reshape(-1, D)
            xf = x_own.reshape(-1, D)
        for s in range(cfg.num_shared):
            y = y + getattr(self, f"shared_{s}")(xf)
        # Switch-style load-balance loss
        me = r.probs.mean(dim=0)
        idx = r.gate_idx.reshape(-1)
        ce = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
            0, idx, torch.full(idx.shape, 1.0 / (N * K),
                               dtype=torch.float32, device=x.device))
        aux = cfg.aux_loss_coef * E * torch.sum(me * ce)
        return y.reshape(x_own.shape).to(x.dtype), aux
