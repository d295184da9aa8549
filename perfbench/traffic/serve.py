"""The generator of serving traffic: an open loop of requests in the
continuous engine's own time, decode steps.

A traffic file of kind ``serve`` gives the prompt lengths' distribution
(``prompt``: ``lognormal`` with ``median`` and ``sigma``, or
``loguniform``, each clipped to [``min``, ``max``]) and the arrival rate
in requests per decode step (``rate_per_step``).  Every seed gets the same
work: request i of n takes the (i + 1/2) / n quantile of the length
distribution, and arrival i the (i + 1/2) / n quantile of the exponential
gap, in an order fixed by the file; the seed shuffles the lengths over
the arrivals and draws the token ids.  So seeds change which prompt comes
when, not how much work there is, nor when requests arrive.
"""
from __future__ import annotations

import math

import numpy as np


def _normal_ppf(p: float) -> float:
    """The standard normal quantile (Acklam's rational approximation,
    relative error < 1.2e-9)."""
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    lo = 0.02425
    if p < lo or p > 1 - lo:
        q = math.sqrt(-2 * math.log(p if p < lo else 1 - p))
        x = (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q
             + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
        return x if p < lo else -x
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r
            + a[5]) * q / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r
                            + b[4]) * r + 1)


def prompt_lengths(spec: dict, n: int) -> list[int]:
    """The n quantile lengths of the prompt distribution, ascending."""
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        if spec["dist"] == "lognormal":
            x = spec["median"] * math.exp(spec["sigma"] * _normal_ppf(u))
        elif spec["dist"] == "loguniform":
            x = spec["min"] * (spec["max"] / spec["min"]) ** u
        else:
            raise ValueError(f"unknown prompt distribution {spec['dist']!r}")
        out.append(int(min(max(round(x), spec["min"]), spec["max"])))
    return out


def requests(traffic: dict, vocab: int, seed: int, n: int):
    """n requests as (prompt tokens, arrival step), in arrival order.  The
    arrival times are the same for every seed: the quantile gaps in an
    order fixed by the traffic file's ``arrival_seed``.  Near capacity
    the order of arrivals decides when the slots run full, and so the
    tail of the time to first token; the seed shuffles which prompt comes
    at which arrival and draws the token ids."""
    fixed = np.random.default_rng([traffic["arrival_seed"], 0])
    gaps = fixed.permutation([-math.log(1 - (i + 0.5) / n)
                              / traffic["rate_per_step"] for i in range(n)])
    arrival = np.cumsum(gaps)
    rng = np.random.default_rng([seed, 1])
    lengths = rng.permutation(prompt_lengths(traffic["prompt"], n))
    return [(tuple(int(t) for t in rng.integers(0, vocab, size=int(k))),
             float(a)) for k, a in zip(lengths, arrival)]
