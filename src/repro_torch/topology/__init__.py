"""repro_torch.topology — spec-driven topology registry (the port's copy
of ``repro/topology``).

    spec  = TopologySpec(name="base", n=25, k=2)     # the only currency
    sched = build_schedule(spec)                     # registry + cache
    Ws, idx = sched.as_dense_stack(steps, device)    # simulation engine

Constructors, metadata laws, canonical specs and their JSON are the
reference's, so a spec names the same matrices in both packages.  The
reference's ``spec_from_cli`` belongs to the launchers, which are not
ported yet.
"""
from __future__ import annotations

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
    "registered_names",
]
