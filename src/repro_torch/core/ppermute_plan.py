"""Compile mixing-matrix rounds into point-to-point "slot plans" (the
port's numpy copy of ``repro/core/ppermute_plan.py``).

A gossip round with maximum degree k decomposes into a small number of
*slots*; each slot is a partial permutation (every node sends at most one
message and receives at most one message), executed by the distributed
runtime as one batch of point-to-point sends and receives
(``repro_torch.dist.gossip``), plus a static per-node receive-weight
vector.  The round's mixing is then

    x' = w_self[me] * x + sum_s w_recv[s][me] * recv_s(x)

which is exactly ``x'_i = sum_j W[i, j] x_j``, with no all-reduce at
all: the paper's degree-k communication saving (DESIGN.md Sec. 3).

Slot assignment is an edge colouring of the bipartite (sender x
receiver) message graph with Delta colours.  The code is the
reference's, line for line, so both packages compile the same plans
(``tests/test_torch_topology.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .graphs import TopologySchedule


@dataclass(frozen=True)
class SlotPlan:
    """One partial permutation: ``perm`` is a tuple of (src, dst) pairs;
    ``recv_weight[i]`` scales what node i receives (0.0 if i receives
    nothing in this slot)."""
    perm: tuple[tuple[int, int], ...]
    recv_weight: np.ndarray  # (n,)


@dataclass(frozen=True)
class RoundPlan:
    self_weight: np.ndarray  # (n,)
    slots: tuple[SlotPlan, ...]

    @property
    def num_messages(self) -> int:
        return sum(len(s.perm) for s in self.slots)


@dataclass(frozen=True)
class SchedulePlan:
    name: str
    n: int
    rounds: tuple[RoundPlan, ...]

    def __len__(self) -> int:
        return len(self.rounds)

    @property
    def max_slots(self) -> int:
        return max((len(r.slots) for r in self.rounds), default=0)


def _bipartite_edge_color(n: int, msgs: list[tuple[int, int]]) -> list[int]:
    """Colour directed messages so that within a colour every node sends at
    most once and receives at most once.  The message graph is bipartite
    (senders x receivers), so by Konig's theorem exactly
    Delta = max(out-degree, in-degree) colours suffice; we realise that via
    the classic alternating-path recolouring algorithm."""
    out_deg = np.zeros(n, dtype=int)
    in_deg = np.zeros(n, dtype=int)
    for (s, d) in msgs:
        out_deg[s] += 1
        in_deg[d] += 1
    delta = int(max(out_deg.max(initial=0), in_deg.max(initial=0)))
    # colour tables: src_col[u][c] = dst of u's colour-c message (or -1)
    src_col = np.full((n, delta), -1, dtype=int)
    dst_col = np.full((n, delta), -1, dtype=int)
    colors = [-1] * len(msgs)
    msg_id: dict[tuple[int, int], int] = {m: i for i, m in enumerate(msgs)}

    def free(table, v):
        for c in range(delta):
            if table[v, c] == -1:
                return c
        raise AssertionError("no free colour — degree bound violated")

    for idx, (u, v) in enumerate(msgs):
        a = free(src_col, u)   # colour free at sender u
        b = free(dst_col, v)   # colour free at receiver v
        if a != b:
            # Walk the maximal alternating a/b path starting at receiver v
            # (v -a-> u1 -b-> v1 -a-> u2 ...), then swap a <-> b along it.
            # This frees colour a at v; the path cannot reach u (it would
            # have to arrive via colour a, which is free at u).
            path: list[tuple[int, int, int]] = []   # (src, dst, colour)
            x, col, recv_side = v, a, True
            while True:
                if recv_side:
                    nxt = int(dst_col[x, col])
                    if nxt == -1:
                        break
                    path.append((nxt, x, col))
                else:
                    nxt = int(src_col[x, col])
                    if nxt == -1:
                        break
                    path.append((x, nxt, col))
                x, col, recv_side = nxt, (b if col == a else a), not recv_side
            for (s, d, c) in path:
                src_col[s, c] = -1
                dst_col[d, c] = -1
            for (s, d, c) in path:
                c2 = b if c == a else a
                src_col[s, c2] = d
                dst_col[d, c2] = s
                colors[msg_id[(s, d)]] = c2
        colors[idx] = a
        src_col[u, a] = v
        dst_col[v, a] = u
    return colors


def compile_round(W: np.ndarray, tol: float = 1e-12) -> RoundPlan:
    """Decompose one doubly-stochastic mixing matrix into slots."""
    n = W.shape[0]
    msgs = sorted((j, i) for i in range(n) for j in range(n)
                  if i != j and abs(W[i, j]) > tol)  # (src, dst)
    colors = _bipartite_edge_color(n, msgs)
    nslots = max(colors, default=-1) + 1
    slots_pairs: list[list[tuple[int, int, float]]] = [[] for _ in range(nslots)]
    for (src, dst), c in zip(msgs, colors):
        slots_pairs[c].append((src, dst, W[dst, src]))
    slots = []
    for pairs in slots_pairs:
        rw = np.zeros(n)
        perm = []
        for (src, dst, w) in pairs:
            perm.append((src, dst))
            rw[dst] = w
        slots.append(SlotPlan(perm=tuple(perm), recv_weight=rw))
    return RoundPlan(self_weight=np.diag(W).copy(), slots=tuple(slots))


def compile_schedule(sched: TopologySchedule) -> SchedulePlan:
    return SchedulePlan(
        name=sched.name, n=sched.n,
        rounds=tuple(compile_round(W) for W in sched.Ws))


# ---------------------------------------------------------------------------
# Plain executor (numpy): the tests use it to prove plan == matrix.
# ---------------------------------------------------------------------------

def apply_round_plan_np(plan: RoundPlan, X: np.ndarray) -> np.ndarray:
    """Execute a RoundPlan on node-major X (n, ...) the way the
    distributed runtime does: a non-receiver of a slot takes zeros."""
    out = plan.self_weight.reshape((-1,) + (1,) * (X.ndim - 1)) * X
    for slot in plan.slots:
        recv = np.zeros_like(X)
        for (src, dst) in slot.perm:
            recv[dst] = X[src]
        out = out + slot.recv_weight.reshape(
            (-1,) + (1,) * (X.ndim - 1)) * recv
    return out
