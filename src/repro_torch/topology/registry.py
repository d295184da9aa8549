"""Topology registry: constructors self-register with their metadata
(the port's copy of ``repro/topology/registry.py``).

Each topology registers once with :func:`register_topology`, declaring:

* ``build(spec) -> TopologySchedule`` — the constructor;
* ``takes_k`` / ``default_k`` — whether the topology is parameterized by
  a degree budget ``k`` and how an omitted ``k`` resolves (the rule
  lives HERE, not at call sites — the historical ``k or default``
  falsy-dispatch bug is structurally impossible);
* ``takes_seed`` / ``extra_params`` — randomized-construction knobs;
* ``finite_time(spec)`` — whether the schedule is finite-time
  convergent (paper Definition 2) for that exact configuration;
* ``max_degree(spec)`` — the metadata law: an upper bound on the
  schedule's maximum degree (tight for the static families);
* ``valid_n(spec)`` — the ``n`` constraint (e.g. smoothness for the
  k-peer hyper-hypercube, powers of two for the 1-peer hypercube);
* ``degrades_gracefully(spec)`` — whether every round of the schedule,
  re-normalized over any surviving-node subset by the failure model's
  rule (:func:`repro_torch.core.mixing.masked_effective_W`), remains exactly
  doubly stochastic with dead nodes isolated on the identity — i.e.
  the topology stays a valid mixer under partial participation
  (DESIGN.md Sec. 11).

Consumers never dispatch on names: they call ``canonicalize`` +
``Registration.build`` via :func:`repro_torch.topology.build_schedule`, so a
new graph family plugs in by registering itself — no consumer edits.
``tests/test_torch_topology.py`` holds every registration against the
reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.core.graphs import TopologySchedule

from .spec import TopologySpec


@dataclass(frozen=True)
class Registration:
    """One registered topology: builder + metadata laws."""
    name: str
    build: Callable[[TopologySpec], TopologySchedule]
    takes_k: bool
    takes_seed: bool
    default_k: Callable[[int], int] | None   # n -> k, when takes_k
    finite_time: Callable[[TopologySpec], bool]
    max_degree: Callable[[TopologySpec], int]
    valid_n: Callable[[TopologySpec], bool]
    degrades_gracefully: Callable[[TopologySpec], bool]
    extra_params: dict            # name -> default value
    aliases: tuple[str, ...]
    description: str


_REGISTRY: dict[str, Registration] = {}
_ALIASES: dict[str, str] = {}
_ORDER: list[str] = []            # names + aliases, registration order


def _as_law(v, kind):
    """Constants are promoted to constant laws."""
    if callable(v):
        return v
    if kind == "bool":
        return lambda spec, _v=bool(v): _v
    return lambda spec, _v=int(v): _v


def register_topology(name: str, *, aliases: tuple[str, ...] = (),
                      takes_k: bool = False, takes_seed: bool = False,
                      default_k: Callable[[int], int] | None = None,
                      finite_time, max_degree,
                      valid_n: Callable[[TopologySpec], bool] | None = None,
                      degrades_gracefully=True,
                      extra_params: dict | None = None,
                      description: str = ""):
    """Decorator: register ``fn(spec) -> TopologySchedule`` under
    ``name`` (+ aliases) with its metadata laws.  ``finite_time``,
    ``max_degree`` and ``degrades_gracefully`` may be constants or
    callables of the canonical spec.  ``degrades_gracefully`` defaults
    to True: the renormalization rule is exact for every doubly
    stochastic round, so only a topology that ships rounds violating
    that invariant should opt out."""
    def deco(fn):
        # check every name before inserting any, so a collision cannot
        # leave a half-completed registration behind
        for nm in (name,) + tuple(aliases):
            if nm in _REGISTRY or nm in _ALIASES:
                kind = "alias" if nm != name else "topology"
                raise ValueError(f"{kind} {nm!r} already registered")
        doc = (fn.__doc__ or "").strip().splitlines()
        reg = Registration(
            name=name, build=fn, takes_k=takes_k, takes_seed=takes_seed,
            default_k=default_k,
            finite_time=_as_law(finite_time, "bool"),
            max_degree=_as_law(max_degree, "int"),
            valid_n=valid_n or (lambda spec: True),
            degrades_gracefully=_as_law(degrades_gracefully, "bool"),
            extra_params=dict(extra_params or {}),
            aliases=tuple(aliases),
            description=description or (doc[0] if doc else ""))
        _REGISTRY[name] = reg
        _ORDER.append(name)
        for a in aliases:
            _ALIASES[a] = name
            _ORDER.append(a)
        return fn
    return deco


def unregister_topology(name: str) -> None:
    """Remove a registration (test hygiene for temporary topologies).
    Also drops every cached Schedule, so a later re-registration under
    the same name can never serve stale builds."""
    reg = _REGISTRY.pop(name, None)
    if reg is None:
        return
    _ORDER.remove(name)
    for a in reg.aliases:
        _ALIASES.pop(a, None)
        _ORDER.remove(a)
    from .schedule import _build_cached   # late: schedule imports us
    _build_cached.cache_clear()


def get_registration(name: str) -> Registration:
    """Resolve ``name`` (or an alias) to its Registration."""
    reg = _REGISTRY.get(_ALIASES.get(name, name))
    if reg is None:
        raise ValueError(f"unknown topology {name!r}; registered: "
                         f"{registered_names(include_aliases=True)}")
    return reg


def registered_names(include_aliases: bool = False) -> tuple[str, ...]:
    if include_aliases:
        return tuple(_ORDER)
    return tuple(n for n in _ORDER if n in _REGISTRY)


def canonicalize(spec: TopologySpec) -> TopologySpec:
    """Validate ``spec`` against its registration and return the
    fully-explicit canonical form (default ``k`` resolved, ignored
    ``k``/``seed`` dropped, declared extras filled with defaults) so
    equal configurations compare and hash equal, and every embedded
    artifact spec is attributable without knowing the defaults."""
    reg = get_registration(spec.name)
    k = spec.k
    if reg.takes_k:
        if k is None and reg.default_k is not None:
            k = int(reg.default_k(spec.n))
        if k is None:
            raise ValueError(f"topology {spec.name!r} requires k "
                             f"(no registered default)")
    else:
        k = None                      # ignored by this topology
    seed = spec.seed if reg.takes_seed else 0
    extra = spec.extra_dict
    unknown = set(extra) - set(reg.extra_params)
    if unknown:
        raise ValueError(
            f"topology {spec.name!r} does not accept extra params "
            f"{sorted(unknown)}; declared: {sorted(reg.extra_params)}")
    full_extra = {**reg.extra_params, **extra}
    canon = TopologySpec(name=spec.name, n=spec.n, k=k, seed=seed,
                         extra=full_extra)
    if not reg.valid_n(canon):
        raise ValueError(f"invalid n={spec.n} for topology {spec.name!r}"
                         + (f" with k={k}" if reg.takes_k else ""))
    return canon
