"""Topology constructions from "Beyond Exponential Graph" (NeurIPS 2023).

Implements, faithfully to the paper's Algorithms 1-3:
  * Alg. 1  k-peer Hyper-hypercube graph  H_k(V)
  * Alg. 2  Simple Base-(k+1) graph       A_k^simple(V)
  * Alg. 3  Base-(k+1) graph              A_k(V)

plus the baseline topologies compared against in the paper (ring, torus,
exponential, 1-peer exponential, 1-peer hypercube, complete / all-reduce).

A topology is a *sequence of rounds*; each round is a set of weighted
undirected edges (or, for the directed exponential-family graphs, an
explicit doubly-stochastic mixing matrix).  Nodes are 0-indexed ints.

Everything here is pure Python/numpy.  This is the port's copy of
``repro/core/graphs.py``: the port imports nothing of ``repro``, so it
keeps its own.  The constructors are the reference's, line for line, so
both packages build the same matrices bit for bit
(``tests/test_torch_topology.py``).  The reference's deprecated shims
``build_topology`` / ``TOPOLOGY_NAMES`` are not carried over: build a
``repro_torch.topology.TopologySpec`` with ``build_schedule``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction
from functools import lru_cache

import numpy as np

Edge = tuple[int, int]          # (i, j) with i < j, undirected
EdgeSet = dict[Edge, Fraction]  # edge -> weight (exact rational arithmetic)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= x
    return out


def is_smooth(n: int, bound: int) -> bool:
    """True iff all prime factors of ``n`` are <= ``bound``."""
    for p in range(2, bound + 1):
        while n % p == 0:
            n //= p
    return n == 1


@lru_cache(maxsize=None)
def min_factorization(n: int, bound: int) -> tuple[int, ...] | None:
    """Decompose ``n = n_1 x ... x n_L`` with each ``n_l <= bound`` and
    minimal ``L`` (Alg. 1 line 2).  Returns ascending factors or None if a
    prime factor of ``n`` exceeds ``bound``."""
    if n == 1:
        return ()
    if n <= bound:
        return (n,)
    best: tuple[int, ...] | None = None
    for d in range(bound, 1, -1):
        if n % d == 0:
            sub = min_factorization(n // d, bound)
            if sub is not None and (best is None or len(sub) + 1 < len(best)):
                best = tuple(sorted(sub + (d,)))
    return best


def base_digits(n: int, base: int) -> list[tuple[int, int]]:
    """Base-``base`` expansion ``n = sum_l a_l * base**p_l`` with nonzero
    digits only, returned as [(a_1, p_1), ...] with p_1 > p_2 > ... >= 0."""
    out = []
    p = 0
    while n:
        a = n % base
        if a:
            out.append((a, p))
        n //= base
        p += 1
    return sorted(out, key=lambda t: -t[1])


def _add_edge(E: EdgeSet, i: int, j: int, w: Fraction) -> None:
    if i == j:
        return
    e = (min(i, j), max(i, j))
    E[e] = E.get(e, Fraction(0)) + w


# ---------------------------------------------------------------------------
# Alg. 1 — k-peer Hyper-hypercube graph
# ---------------------------------------------------------------------------

def hyper_hypercube(nodes: list[int], k: int) -> list[EdgeSet]:
    """k-peer Hyper-hypercube graph H_k(V) (paper Alg. 1).

    Requires all prime factors of ``len(nodes)`` to be <= k+1.
    Returns an L-round finite-time convergent sequence of edge sets with
    maximum degree <= k (each round is a disjoint union of complete graphs
    of size ``n_l`` with stride ``prod(n_1..n_{l-1})``).
    """
    n = len(nodes)
    if n == 1:
        return []
    factors = min_factorization(n, k + 1)
    if factors is None:
        raise ValueError(f"n={n} has a prime factor > {k + 1}")
    rounds: list[EdgeSet] = []
    for l, nl in enumerate(factors):
        stride = _prod(factors[:l])
        b = [0] * n
        E: EdgeSet = {}
        seen: set[Edge] = set()
        for i in range(n):
            for m in range(1, nl + 1):
                j = (i + m * stride) % n
                if j == i:
                    continue
                e = (min(i, j), max(i, j))
                if e in seen:
                    continue
                if b[i] < nl - 1 and b[j] < nl - 1:
                    seen.add(e)
                    _add_edge(E, nodes[i], nodes[j], Fraction(1, nl))
                    b[i] += 1
                    b[j] += 1
        rounds.append(E)
    return rounds


# ---------------------------------------------------------------------------
# Alg. 2 — Simple Base-(k+1) graph
# ---------------------------------------------------------------------------

def simple_base_graph(nodes: list[int], k: int) -> list[EdgeSet]:
    """SIMPLE BASE-(k+1) GRAPH A_k^simple(V) (paper Alg. 2).

    Finite-time convergent for any n and max degree k in [n-1].
    """
    n = len(nodes)
    if n <= 1:
        return []
    # line 2: smooth case -> plain hyper-hypercube
    if is_smooth(n, k + 1):
        return hyper_hypercube(nodes, k)

    digits = base_digits(n, k + 1)            # [(a_l, p_l)], p descending
    L = len(digits)
    # line 3: split V into V_1..V_L, and V_l into subgroups V_{l,1..a_l}
    V: list[list[int]] = []
    sub: list[list[list[int]]] = []           # sub[l][a] = V_{l+1, a+1}
    off = 0
    for a_l, p_l in digits:
        size = a_l * (k + 1) ** p_l
        V.append(nodes[off:off + size])
        g = (k + 1) ** p_l
        sub.append([nodes[off + a * g: off + (a + 1) * g] for a in range(a_l)])
        off += size

    H_V = [hyper_hypercube(v, k) for v in V]          # line 4
    H_sub = [[hyper_hypercube(s, k) for s in subs] for subs in sub]  # line 5
    m1 = len(H_V[0])
    len_H11 = len(H_sub[0][0])                # |H_k(V_{1,1})| = p_1

    sizes = [len(v) for v in V]
    suffix = [sum(sizes[j:]) for j in range(L)] + [0]  # S_j = sum_{l'>=j}|V_l'|

    b = [0] * L
    rounds: list[EdgeSet] = []
    m = 0
    while b[0] < len_H11:
        m += 1
        E: EdgeSet = {}
        deg: dict[int, int] = {}              # node -> degree within round m

        def add(i: int, j: int, w: Fraction) -> None:
            _add_edge(E, i, j, w)
            deg[i] = deg.get(i, 0) + 1
            deg[j] = deg.get(j, 0) + 1

        for l in range(L, 0, -1):             # descending, as in the paper
            li = l - 1
            a_l, p_l = digits[li]
            if m <= m1:                        # line 10-11: initial averaging
                if H_V[li]:
                    for (i, j), w in H_V[li][(m - 1) % len(H_V[li])].items():
                        add(i, j, w)
            elif m < m1 + l:                   # line 12-15: exchange with V_j
                j_grp = m - m1                 # 1-based group index being fed
                ji = j_grp - 1
                a_j, _ = digits[ji]
                w = Fraction(sizes[ji], a_j * suffix[ji])
                for v in V[li]:
                    for a in range(a_j):
                        u = next(u for u in sub[ji][a] if u not in deg)
                        add(v, u, w)
            elif m == m1 + l and l != L:       # line 16-20: leftover cliques
                iso = [u for u in V[li] if u not in deg]
                while len(iso) >= 2:
                    take, iso = iso[:k + 1], iso[k + 1:]
                    for x in range(len(take)):
                        for y in range(x + 1, len(take)):
                            add(take[x], take[y], Fraction(1, len(take)))
            else:                              # line 21-27: re-average groups
                b[li] += 1
                if p_l != 0:
                    for a in range(a_l):
                        h = H_sub[li][a]
                        if h:
                            for (i, j), w in h[(b[li] - 1) % len(h)].items():
                                add(i, j, w)
                else:
                    if H_V[li]:
                        h = H_V[li]
                        for (i, j), w in h[(b[li] - 1) % len(h)].items():
                            add(i, j, w)
        rounds.append(E)
    return rounds


# ---------------------------------------------------------------------------
# Alg. 3 — Base-(k+1) graph
# ---------------------------------------------------------------------------

def base_graph(nodes: list[int], k: int) -> list[EdgeSet]:
    """BASE-(k+1) GRAPH A_k(V) (paper Alg. 3).

    Decomposes n = p*q with p (k+1)-smooth and q coprime to 2..k+1, runs
    SIMPLE BASE-(k+1) on p parallel groups of size q, then one k-peer
    hyper-hypercube pass over the q transversal sets; returns whichever of
    this and A_k^simple(V) is shorter (paper line 12).
    """
    n = len(nodes)
    if n <= 1:
        return []
    # smooth part p, rough part q
    p = 1
    q = n
    for f in range(2, k + 2):
        while q % f == 0:
            q //= f
            p *= f
    simple = simple_base_graph(nodes, k)
    if p == 1 or q == 1:
        # degenerate: Alg. 3 reduces to Simple (q==n) or to H_k (q==1, which
        # Simple already returns via its smooth-case line 2).
        return simple

    groups = [nodes[l * q:(l + 1) * q] for l in range(p)]
    per_group = [simple_base_graph(g, k) for g in groups]
    m_simple_q = len(per_group[0])
    rounds: list[EdgeSet] = []
    for m in range(m_simple_q):
        E: EdgeSet = {}
        for g in per_group:
            E.update(g[m])
        rounds.append(E)
    # transversals U_1..U_q, |U_l| = p, one node per group
    transversals = [[groups[l2][l] for l2 in range(p)] for l in range(q)]
    per_trans = [hyper_hypercube(u, k) for u in transversals]
    for m in range(len(per_trans[0])):
        E = {}
        for t in per_trans:
            E.update(t[m])
        rounds.append(E)
    return rounds if len(rounds) < len(simple) else simple


# ---------------------------------------------------------------------------
# Baseline topologies (paper Sec. 6 comparisons)
# ---------------------------------------------------------------------------

def ring_matrix(n: int) -> np.ndarray:
    """Static ring, Metropolis weights (degree 2 -> 1/3 each for n >= 3)."""
    W = np.zeros((n, n))
    for i in range(n):
        for j in ((i - 1) % n, (i + 1) % n):
            if j != i:
                W[i, j] += 1.0 / 3.0 if n > 2 else 0.5
    np.fill_diagonal(W, 0)
    W[np.diag_indices(n)] = 1.0 - W.sum(axis=1)
    return W


def torus_matrix(n: int) -> np.ndarray:
    """Static 2-D torus (r x c with r the largest divisor <= sqrt(n)),
    Metropolis weights.  Falls back to the ring when n is prime."""
    r = 1
    for d in range(2, int(math.isqrt(n)) + 1):
        if n % d == 0:
            r = d
    if r == 1:
        return ring_matrix(n)
    c = n // r
    W = np.zeros((n, n))
    deg = np.zeros(n, dtype=int)
    edges = set()
    for i in range(n):
        x, y = divmod(i, c)
        for (dx, dy) in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            j = ((x + dx) % r) * c + (y + dy) % c
            if j != i:
                e = (min(i, j), max(i, j))
                if e not in edges:
                    edges.add(e)
    for (i, j) in edges:
        deg[i] += 1
        deg[j] += 1
    for (i, j) in edges:
        w = 1.0 / (max(deg[i], deg[j]) + 1)
        W[i, j] += w
        W[j, i] += w
    W[np.diag_indices(n)] = 1.0 - W.sum(axis=1)
    return W


def exponential_matrix(n: int) -> np.ndarray:
    """Static (dense) exponential graph: i -> i + 2^j mod n, uniform weights.
    Directed but doubly stochastic (circulant)."""
    if n == 1:
        return np.ones((1, 1))
    tau = max(1, math.ceil(math.log2(n)))
    offsets = sorted({2 ** j % n for j in range(tau)} - {0})
    w = 1.0 / (len(offsets) + 1)
    W = np.zeros((n, n))
    for i in range(n):
        W[i, i] = w
        for o in offsets:
            W[(i + o) % n, i] += w  # column-stochastic send; row gets receive
    return W


def one_peer_exponential_matrices(n: int) -> list[np.ndarray]:
    """1-peer exponential graph [Ying et al. 2021]: round t pairs i -> i+2^t.
    W^(t) = (I + P_t)/2 with P_t the cyclic-shift-by-2^t permutation."""
    tau = max(1, math.ceil(math.log2(n)))
    out = []
    for t in range(tau):
        P = np.zeros((n, n))
        for i in range(n):
            P[(i + 2 ** t) % n, i] = 1.0
        out.append(0.5 * (np.eye(n) + P))
    return out


def one_peer_hypercube(nodes: list[int]) -> list[EdgeSet]:
    """1-peer hypercube graph [Shi et al. 2016]; n must be a power of 2."""
    n = len(nodes)
    if n & (n - 1):
        raise ValueError("1-peer hypercube requires n to be a power of 2")
    return hyper_hypercube(nodes, 1)


def complete_matrix(n: int) -> np.ndarray:
    return np.full((n, n), 1.0 / n)


# -- EquiTopo family [Song et al. 2022], the paper's Sec. F.3.1 baseline --

def _shift(n: int, a: int) -> np.ndarray:
    P = np.zeros((n, n))
    P[(np.arange(n) + a) % n, np.arange(n)] = 1.0
    return P


def d_equistatic_matrix(n: int, degree: int, seed: int = 0) -> np.ndarray:
    """D-EquiStatic: W = (I + sum_i P^{a_i}) / (degree + 1) with random
    shift offsets a_i — directed, doubly stochastic, O(1) consensus."""
    rng = np.random.default_rng(seed)
    offs = rng.choice(np.arange(1, n), size=degree, replace=False) \
        if n > degree else np.arange(1, n)
    W = np.eye(n)
    for a in offs:
        W = W + _shift(n, int(a))
    return W / (len(offs) + 1)


def u_equistatic_matrix(n: int, degree: int, seed: int = 0) -> np.ndarray:
    """U-EquiStatic: symmetrised variant (undirected), max degree ~2M."""
    rng = np.random.default_rng(seed)
    m = max(1, degree // 2)
    offs = rng.choice(np.arange(1, n), size=m, replace=False) \
        if n > m else np.arange(1, n)
    W = np.eye(n)
    for a in offs:
        P = _shift(n, int(a))
        W = W + P + P.T
    return W / (2 * len(offs) + 1)


def one_peer_equidyn_matrices(n: int, rounds: int = 8,
                              seed: int = 0) -> list[np.ndarray]:
    """1-peer D-EquiDyn: round t mixes with a single random cyclic shift,
    W_t = (I + P^{a_t}) / 2 — degree 1, O(1) consensus in expectation."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        a = int(rng.integers(1, n))
        out.append(0.5 * (np.eye(n) + _shift(n, a)))
    return out


# ---------------------------------------------------------------------------
# Schedule container + registry
# ---------------------------------------------------------------------------

def edges_to_matrix(E: EdgeSet, n: int) -> np.ndarray:
    """Doubly-stochastic symmetric mixing matrix from an undirected edge set
    (self-weights = 1 - row sum)."""
    W = np.zeros((n, n))
    for (i, j), w in E.items():
        W[i, j] += float(w)
        W[j, i] += float(w)
    d = W.sum(axis=1)
    if (d > 1.0 + 1e-9).any():
        raise ValueError(f"row sum exceeds 1: {d.max()}")
    W[np.diag_indices(n)] = 1.0 - d
    return W


@dataclass
class TopologySchedule:
    """A (possibly time-varying) gossip schedule: round r uses matrix
    ``W(r) = Ws[r % len(Ws)]``."""
    name: str
    n: int
    Ws: list[np.ndarray]
    edge_rounds: list[EdgeSet] | None = None   # None for directed matrices
    finite_time: bool = False
    k: int | None = None

    def __post_init__(self):
        for W in self.Ws:
            assert W.shape == (self.n, self.n)

    def __len__(self) -> int:
        return len(self.Ws)

    def W(self, r: int) -> np.ndarray:
        return self.Ws[r % len(self.Ws)]

    @property
    def max_degree(self) -> int:
        degs = []
        for W in self.Ws:
            off = (W - np.diag(np.diag(W))) != 0
            degs.append(int(np.maximum(off.sum(0), off.sum(1)).max()))
        return max(degs)

    def bytes_per_node_per_round(self, param_bytes: int) -> float:
        """Average communication volume (send side) per node per round."""
        tot = 0.0
        for W in self.Ws:
            off = (W - np.diag(np.diag(W))) != 0
            tot += off.sum()  # directed messages
        return tot / len(self.Ws) / self.n * param_bytes


def _edge_schedule(name, n, rounds, k=None, finite_time=True):
    if not rounds:  # n == 1
        rounds = [{}]
    return TopologySchedule(
        name=name, n=n, Ws=[edges_to_matrix(E, n) for E in rounds],
        edge_rounds=rounds, finite_time=finite_time, k=k)
