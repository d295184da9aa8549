"""Verification & evaluation utilities for mixing-matrix schedules (the
port's numpy copy of ``repro/core/mixing.py``).

Convention used throughout the framework (matches paper Eq. (1)):
    node i's post-gossip value  x_i' = sum_j W[i, j] x_j
so with node-major stacking X in R^{n x d}:  X' = W @ X.

These implement the paper's Definitions 1-2 checks and the consensus-rate
experiment of Sec. 6.1.
"""
from __future__ import annotations

import numpy as np

from .graphs import TopologySchedule


def is_doubly_stochastic(W: np.ndarray, atol: float = 1e-9) -> bool:
    n = W.shape[0]
    ones = np.ones(n)
    return (
        bool((W >= -atol).all())
        and np.allclose(W @ ones, ones, atol=atol)
        and np.allclose(W.T @ ones, ones, atol=atol)
    )


def schedule_product(sched: TopologySchedule) -> np.ndarray:
    """Product of mixing matrices in application order:
    X_m = W^(m) ... W^(1) X_0."""
    P = np.eye(sched.n)
    for W in sched.Ws:
        P = W @ P
    return P


def is_finite_time_convergent(sched: TopologySchedule,
                              atol: float = 1e-8) -> bool:
    """Definition 2: applying the full schedule averages any X exactly
    <=> the ordered product equals (1/n) 1 1^T."""
    n = sched.n
    P = schedule_product(sched)
    return bool(np.allclose(P, np.full((n, n), 1.0 / n), atol=atol))


def consensus_error_curve(sched: TopologySchedule, iters: int,
                          seed: int = 0, d: int = 1) -> np.ndarray:
    """Paper Sec. 6.1: x_i ~ N(0,1); track (1/n) sum_i ||x_i - xbar||^2 as
    X <- W X is applied round-robin over the schedule."""
    rng = np.random.default_rng(seed)
    n = sched.n
    X = rng.standard_normal((n, d))
    errs = np.empty(iters + 1)

    def err(X):
        xbar = X.mean(axis=0, keepdims=True)
        return float(((X - xbar) ** 2).sum(axis=1).mean())

    errs[0] = err(X)
    for r in range(iters):
        X = sched.W(r) @ X
        errs[r + 1] = err(X)
    return errs


def spectral_consensus_rate(W: np.ndarray) -> float:
    """beta for a static topology: largest singular value of
    W - (1/n) 1 1^T (paper Definition 1)."""
    n = W.shape[0]
    M = W - np.full((n, n), 1.0 / n)
    return float(np.linalg.svd(M, compute_uv=False)[0])


# ---------------------------------------------------------------------------
# failure-realistic rounds: effective mixing over surviving nodes
# ---------------------------------------------------------------------------

def masked_effective_W(W: np.ndarray, alive: np.ndarray) -> np.ndarray:
    """Re-normalize one round's matrix for a partial-participation round
    so it stays EXACTLY doubly stochastic over the whole node set, with
    every dead node isolated on the identity (numpy; the failure model
    applies the same rule per round in torch,
    :func:`repro_torch.sim.failure.effective_W`).

    Rule (DESIGN.md Sec. 11): zero every edge touching a dead node, put
    dead nodes on the identity, absorb the elementwise-matched part of
    the lost row/column mass onto the survivors' diagonals (the classic
    rule — exact on its own for symmetric rounds), and route the
    asymmetric residual through the rank-one coupling
    ``outer(r, c) / sum(r)`` between row-deficit and column-deficit
    survivors (row and column deficits always total the same lost mass
    for a doubly stochastic ``W``, so the repair is exact for directed
    rounds too).  With all nodes alive the input is returned unchanged.
    """
    a = np.asarray(alive, dtype=W.dtype)
    if a.all():
        return W
    Weff = W * a[:, None] * a[None, :] + np.diag(1.0 - a)
    r = a * (1.0 - Weff.sum(axis=1))      # per-survivor row deficit
    c = a * (1.0 - Weff.sum(axis=0))      # per-survivor column deficit
    d = np.minimum(r, c)
    Weff = Weff + np.diag(d)
    r, c = r - d, c - d                   # disjoint supports after d
    s = r.sum()
    if s > 1e-12:
        Weff = Weff + np.outer(r, c) / s
    return Weff


def effective_neighbors_matrix(W: np.ndarray) -> float:
    """Effective number of neighbors of one mixing matrix (Vogels et
    al., "Beyond spectral gap"): averaging iid unit-variance noise with
    row i leaves variance ``||W[i, :]||^2``, i.e. node i effectively
    averaged over ``1 / ||W[i, :]||^2`` peers.  Aggregated over nodes as
    ``n / ||W||_F^2`` (the harmonic mean of the per-node counts):
    uniform averaging over m peers scores m; the identity scores 1; the
    complete graph scores n."""
    n = W.shape[0]
    return float(n / max((np.asarray(W, np.float64) ** 2).sum(), 1e-300))


def effective_neighbors(sched: TopologySchedule, *,
                        per_round: bool = False) -> float:
    """Schedule-level effective number of neighbors: the metric of the
    full-period product (finite-time schedules score exactly ``n``), or
    with ``per_round=True`` the mean single-round metric (what one
    unreliable round buys)."""
    if per_round:
        return float(np.mean([effective_neighbors_matrix(W)
                              for W in sched.Ws]))
    return effective_neighbors_matrix(schedule_product(sched))
