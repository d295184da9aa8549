"""Plain float32 layers the references share: written from the layer
equations in plain PyTorch, with no kernel, cache or batching of the port
and nothing imported from it.  TF32 is switched off by :func:`strict`.

Every matrix product goes through :class:`Precision`: ``"f32"`` is the
reference; ``"fp8"`` rounds both operands of every product to float8
e4m3 with a per-tensor scale first, the control that stands one precision
below the configurations' bfloat16 and has to come out as not correct.
"""
from __future__ import annotations

import math
from fractions import Fraction

import torch

NEG_INF = -1e30


def strict() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` in float32, or as float8 e4m3 holds it (scaled so that its
        largest magnitude is the format's 448); a backward pass takes the
        rounding as the identity (the products' backward then runs on the
        rounded operands)."""
        x = x.float()
        if self.name == "f32":
            return x
        s = (x.detach().abs().amax() / 448.0).clamp_min(1e-30)
        r = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
        return x + (r - x.detach())

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)


def rmsnorm(x, scale, eps: float = 1e-6):
    """x / rms(x) * (1 + scale), the configurations' norm."""
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def rope(x, pos, theta: float = 10000.0):
    """Rotate (..., T, H, hd) by positions (T,) or (B, T): the half-split
    rotary embedding."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(half, device=x.device,
                                   dtype=torch.float64) / half)
    ang = pos[..., None].double() * freq
    cos = torch.cos(ang).float()[..., None, :]
    sin = torch.sin(ang).float()[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def attend(pr: Precision, q, k, v, mask, softcap=None):
    """Softmax attention of q (Tq, H, hd) over k, v (S, KV, hd), H a
    multiple of KV (each k/v head serves H / KV query heads in order);
    ``mask`` (Tq, S) marks the visible keys.  Scale hd^-1/2, scores
    capped by ``softcap * tanh(s / softcap)`` where given."""
    H = q.shape[1]
    g = H // k.shape[1]
    kk = k.repeat_interleave(g, dim=1).transpose(0, 1)      # (H, S, hd)
    vv = v.repeat_interleave(g, dim=1).transpose(0, 1)
    s = pr.mm(q.transpose(0, 1), kk.transpose(1, 2)) * q.shape[-1] ** -0.5
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    return pr.mm(p, vv).transpose(0, 1)                     # (Tq, H, hd)


def causal_mask(tq: int, s: int, device, q0: int = 0):
    qpos = q0 + torch.arange(tq, device=device)
    return torch.arange(s, device=device)[None, :] <= qpos[:, None]


def gated_ffn(pr: Precision, x, w_gate, w_up, w_down):
    return pr.mm(gelu(pr.mm(x, w_gate)) * pr.mm(x, w_up), w_down)


def cross_entropy(logits, labels):
    """Sum of -log softmax at the labels (labels < 0 ignored), and the
    count of labelled rows."""
    valid = labels >= 0
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp_min(0)[:, None])[:, 0]
    return torch.where(valid, lse - gold, 0.0).sum(), valid.sum()


# ---------------------------------------------------------------------------
# Base-(k+1) mixing: a frozen copy of the paper's Algorithms 1-3 as the
# port's ``core/graphs.py`` has them (the k-peer hyper-hypercube, the
# simple Base-(k+1) graph and the Base-(k+1) graph), rounds of edge sets
# with exact fractional weights, made dense below.
# ---------------------------------------------------------------------------

Edge = tuple
EdgeSet = dict


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


def base_matrices(n: int, k: int) -> list[torch.Tensor]:
    """The rounds of the Base-(k+1) graph over n nodes as dense (n, n)
    float64 matrices (self-weight one less the row's other weights)."""
    rounds = base_graph(list(range(n)), k) or [{}]
    mats = []
    for E in rounds:
        W = [[Fraction(0)] * n for _ in range(n)]
        for (i, j), w in E.items():
            W[i][j] += w
            W[j][i] += w
        for i in range(n):
            W[i][i] = 1 - sum(W[i][j] for j in range(n) if j != i)
        mats.append(torch.tensor([[float(w) for w in row] for row in W],
                                 dtype=torch.float64))
    return mats
