"""Built-in topology registrations (the port's copy of
``repro/topology/builtins.py``).

Every topology the repo ships — the paper's Base-(k+1) family
(Algorithms 1-3), the Sec. 6 baselines, and the EquiTopo family of Song
et al. — registers here with its metadata laws.  The constructors stay
in :mod:`repro_torch.core.graphs` (pure numpy); this module only binds them
to specs.  Construction is bit-exact with the reference's
(tests/test_torch_topology.py).

Metadata conventions:

* ``max_degree`` is an upper-bound law; it is tight for the static
  families and the paper's ``<= k`` bound for the Base-(k+1) family.
* ``finite_time`` is exact per configuration — e.g. the 1-peer
  exponential graph is finite-time iff ``n`` is a power of two, the
  dense exponential graph iff its offsets cover every non-zero shift
  (tiny ``n``), D-EquiStatic iff the random offsets necessarily exhaust
  all shifts (``n <= k + 1``).
* ``degrades_gracefully`` is left at its registry default (True) for
  every builtin: all rounds shipped here are exactly doubly stochastic,
  which is precisely the invariant the failure model's
  partial-participation re-normalization needs (exact even for the
  DIRECTED rounds — exp / D-EquiStatic — via the rank-one residual
  rule, see repro_torch.core.mixing.masked_effective_W).  The reference's
  conformance suite (tests/test_topology_registry.py) checks the claim
  against sampled survivor masks for every registration, so a future
  topology whose rounds break the invariant must register
  ``degrades_gracefully=False`` or fail conformance.
"""
from __future__ import annotations

import math

from repro_torch.core.graphs import (
    TopologySchedule, _edge_schedule, base_graph, complete_matrix,
    d_equistatic_matrix, exponential_matrix, hyper_hypercube,
    min_factorization, one_peer_equidyn_matrices,
    one_peer_exponential_matrices, one_peer_hypercube, ring_matrix,
    simple_base_graph, torus_matrix, u_equistatic_matrix)

from .registry import register_topology
from .spec import TopologySpec


def _bounded_k(spec: TopologySpec) -> int:
    return min(spec.k, spec.n - 1)


def _one_peer(spec: TopologySpec) -> int:
    return 1 if spec.n > 1 else 0


def _ring_degree(n: int) -> int:
    return 0 if n == 1 else (1 if n == 2 else 2)


def _torus_r(n: int) -> int:
    """Row count of the torus grid (largest divisor <= sqrt(n); 1 means
    the constructor falls back to the ring)."""
    r = 1
    for d in range(2, int(math.isqrt(n)) + 1):
        if n % d == 0:
            r = d
    return r


def _torus_degree(spec: TopologySpec) -> int:
    r = _torus_r(spec.n)
    if r == 1:
        return _ring_degree(spec.n)
    c = spec.n // r
    return (1 if r == 2 else 2) + (1 if c == 2 else 2)


def _exp_offsets(n: int) -> int:
    if n == 1:
        return 0
    tau = max(1, math.ceil(math.log2(n)))
    return len({2 ** j % n for j in range(tau)} - {0})


def _u_equi_finite(spec: TopologySpec) -> bool:
    """U-EquiStatic is exactly averaging iff the drawn +-offset pairs
    cover every non-zero shift exactly once with 2m + 1 == n (circulant
    coefficient argument; seed-dependent, so the law replays the
    constructor's draw)."""
    import numpy as np
    n, m = spec.n, max(1, spec.k // 2)
    if n == 1:
        return True
    rng = np.random.default_rng(spec.seed)
    offs = rng.choice(np.arange(1, n), size=m, replace=False) \
        if n > m else np.arange(1, n)
    cover: dict[int, int] = {}
    for a in offs:
        for o in (int(a) % n, (-int(a)) % n):
            cover[o] = cover.get(o, 0) + 1
    return 2 * len(offs) + 1 == n and set(cover) == set(range(1, n)) \
        and all(v == 1 for v in cover.values())


def _equidyn_finite(spec: TopologySpec) -> bool:
    """1-peer D-EquiDyn averages exactly iff the product of its drawn
    circulants (I + P^{a_t})/2 is uniform — derived here on the n-vector
    of circulant coefficients instead of the n x n matrices."""
    import numpy as np
    n = spec.n
    if n == 1:
        return True
    rng = np.random.default_rng(spec.seed)
    c = np.zeros(n)
    c[0] = 1.0
    for _ in range(spec.get_extra("rounds", 8)):
        a = int(rng.integers(1, n))
        c = 0.5 * (c + np.roll(c, a))
    return bool(np.allclose(c, 1.0 / n, atol=1e-8))


# ---------------------------------------------------------------------------
# the paper's finite-time family (Algorithms 1-3)
# ---------------------------------------------------------------------------

@register_topology(
    "base", takes_k=True, finite_time=True, max_degree=_bounded_k,
    description="Base-(k+1) graph (Alg. 3): finite-time, degree <= k, "
                "any n")
def _build_base(spec: TopologySpec) -> TopologySchedule:
    return _edge_schedule(spec.name, spec.n,
                          base_graph(list(range(spec.n)), spec.k), spec.k)


@register_topology(
    "simple_base", takes_k=True, finite_time=True, max_degree=_bounded_k,
    description="Simple Base-(k+1) graph (Alg. 2)")
def _build_simple_base(spec: TopologySpec) -> TopologySchedule:
    return _edge_schedule(spec.name, spec.n,
                          simple_base_graph(list(range(spec.n)), spec.k),
                          spec.k)


@register_topology(
    "hyper_hypercube", takes_k=True, finite_time=True,
    max_degree=_bounded_k,
    valid_n=lambda s: min_factorization(s.n, s.k + 1) is not None,
    description="k-peer hyper-hypercube H_k (Alg. 1): requires "
                "(k+1)-smooth n")
def _build_hyper_hypercube(spec: TopologySpec) -> TopologySchedule:
    return _edge_schedule(spec.name, spec.n,
                          hyper_hypercube(list(range(spec.n)), spec.k),
                          spec.k)


@register_topology(
    "one_peer_hypercube", finite_time=True, max_degree=_one_peer,
    valid_n=lambda s: s.n & (s.n - 1) == 0,
    description="1-peer hypercube [Shi et al. 2016]: n must be 2^p")
def _build_one_peer_hypercube(spec: TopologySpec) -> TopologySchedule:
    return _edge_schedule(spec.name, spec.n,
                          one_peer_hypercube(list(range(spec.n))), 1)


# ---------------------------------------------------------------------------
# static / exponential-family baselines (paper Sec. 6)
# ---------------------------------------------------------------------------

@register_topology(
    "ring", finite_time=lambda s: s.n in (1, 3),
    max_degree=lambda s: _ring_degree(s.n),
    description="static ring, Metropolis weights")
def _build_ring(spec: TopologySpec) -> TopologySchedule:
    return TopologySchedule(spec.name, spec.n, [ring_matrix(spec.n)],
                            None, False, 2)


@register_topology(
    "torus",
    finite_time=lambda s: _torus_r(s.n) == 1 and s.n in (1, 3),
    max_degree=_torus_degree,
    description="static 2-D torus, Metropolis weights (ring fallback "
                "for prime n)")
def _build_torus(spec: TopologySpec) -> TopologySchedule:
    return TopologySchedule(spec.name, spec.n, [torus_matrix(spec.n)],
                            None, False, 4)


@register_topology(
    "exp", finite_time=lambda s: _exp_offsets(s.n) == s.n - 1,
    max_degree=lambda s: _exp_offsets(s.n),
    description="static exponential graph: i -> i + 2^j mod n")
def _build_exp(spec: TopologySpec) -> TopologySchedule:
    return TopologySchedule(spec.name, spec.n,
                            [exponential_matrix(spec.n)], None, False)


@register_topology(
    "one_peer_exp", finite_time=lambda s: s.n & (s.n - 1) == 0,
    max_degree=_one_peer,
    description="1-peer exponential graph [Ying et al. 2021]")
def _build_one_peer_exp(spec: TopologySpec) -> TopologySchedule:
    return TopologySchedule(spec.name, spec.n,
                            one_peer_exponential_matrices(spec.n),
                            None, spec.n & (spec.n - 1) == 0, 1)


@register_topology(
    "complete", aliases=("allreduce",), finite_time=True,
    max_degree=lambda s: s.n - 1,
    description="complete graph / all-reduce equivalent")
def _build_complete(spec: TopologySpec) -> TopologySchedule:
    return TopologySchedule(spec.name, spec.n, [complete_matrix(spec.n)],
                            None, True, spec.n - 1)


# ---------------------------------------------------------------------------
# EquiTopo family [Song et al. 2022] (paper Sec. F.3.1 baseline)
# ---------------------------------------------------------------------------

@register_topology(
    "d_equistatic", takes_k=True, takes_seed=True,
    default_k=lambda n: max(1, math.ceil(math.log2(n))),
    finite_time=lambda s: s.n <= s.k + 1,        # offsets exhaust Z_n \ 0
    max_degree=_bounded_k,
    description="D-EquiStatic: W = (I + sum P^{a_i}) / (k + 1), random "
                "directed shifts")
def _build_d_equistatic(spec: TopologySpec) -> TopologySchedule:
    return TopologySchedule(
        spec.name, spec.n,
        [d_equistatic_matrix(spec.n, spec.k, spec.seed)], None, False,
        spec.k)


@register_topology(
    "u_equistatic", takes_k=True, takes_seed=True,
    default_k=lambda n: max(2, 2 * math.ceil(math.log2(n) / 2)),
    finite_time=_u_equi_finite,
    max_degree=lambda s: min(2 * max(1, s.k // 2), s.n - 1),
    description="U-EquiStatic: symmetrised EquiStatic, max degree ~2M")
def _build_u_equistatic(spec: TopologySpec) -> TopologySchedule:
    return TopologySchedule(
        spec.name, spec.n,
        [u_equistatic_matrix(spec.n, spec.k, spec.seed)], None, False,
        spec.k)


@register_topology(
    "one_peer_equidyn", takes_seed=True, extra_params={"rounds": 8},
    finite_time=_equidyn_finite,
    max_degree=_one_peer,
    description="1-peer D-EquiDyn: one random cyclic shift per round")
def _build_one_peer_equidyn(spec: TopologySpec) -> TopologySchedule:
    return TopologySchedule(
        spec.name, spec.n,
        one_peer_equidyn_matrices(spec.n, rounds=spec.get_extra("rounds", 8),
                                  seed=spec.seed), None, False, 1)
