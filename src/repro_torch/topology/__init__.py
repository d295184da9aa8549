"""repro_torch.topology — spec-driven topology registry (the port's copy
of ``repro/topology``).

    spec  = TopologySpec(name="base", n=25, k=2)     # the only currency
    sched = build_schedule(spec)                     # registry + cache
    Ws, idx = sched.as_dense_stack(steps, device)    # simulation engine
    plan = sched.as_ppermute_plan()                  # distributed runtime

Constructors, metadata laws, canonical specs and their JSON are the
reference's, so a spec names the same matrices in both packages.
"""
from __future__ import annotations

import json

from .registry import (Registration, canonicalize, get_registration,
                       register_topology, registered_names,
                       unregister_topology)
from .schedule import Schedule, as_schedule, build_schedule
from .spec import TopologySpec

from . import builtins as _builtins   # noqa: F401  (self-registration)

__all__ = [
    "TopologySpec", "Schedule", "Registration",
    "build_schedule", "as_schedule", "canonicalize",
    "register_topology", "unregister_topology", "get_registration",
    "registered_names", "spec_from_cli",
]


def spec_from_cli(value, *, n: int, k: int | None = None,
                  seed: int = 0) -> TopologySpec:
    """Launcher helper (the reference's ``topology.spec_from_cli``):
    ``value`` is a topology name (``"base"``) or an inline JSON spec
    (``'{"name":"base","k":2}'``); ``n`` comes from the node count and
    fills an omitted ``"n"``.  Returns the canonical spec."""
    if isinstance(value, TopologySpec):
        spec = value
    else:
        s = str(value).strip()
        if s.startswith("{"):
            d = json.loads(s)
            d.setdefault("n", n)
            spec = TopologySpec.from_dict(d)
        else:
            spec = TopologySpec(name=s, n=n, k=k, seed=seed)
    if spec.n != n:
        raise ValueError(f"topology spec names n={spec.n} but the runtime "
                         f"provides n={n} nodes")
    return canonicalize(spec)
