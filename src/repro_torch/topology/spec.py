"""TopologySpec — the single currency for naming a topology configuration
(the port's copy of ``repro/topology/spec.py``; a spec serialises to the
same JSON in both packages).

A spec is a frozen, hashable, JSON-round-trippable value object: `(name,
n, k, seed, extra)`.  It is what launchers parse from the CLI, what
benchmark artifacts embed next to every row, and what keys the
memoization of compiled backend artifacts (see DESIGN.md Sec. 2).  A
spec carries NO construction logic — the registry
(:mod:`repro_torch.topology.registry`) owns validation, default-``k`` rules
and the builder functions.

Two specs are interchangeable iff they are equal; ``canonicalize``
(registry) maps user input (omitted ``k``, ignored ``seed``) onto the
fully-explicit canonical form so equal configurations hash equally.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field, fields


def _hashable(v):
    """Recursively convert JSON-style values to hashable equivalents."""
    if isinstance(v, dict):
        return tuple(sorted((str(k), _hashable(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(x) for x in v)
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    raise TypeError(f"spec extra values must be JSON-style, got {type(v)}")


def _jsonable(v):
    """Inverse-ish of ``_hashable``: tuples of pairs -> dicts for JSON."""
    if isinstance(v, tuple) and v and all(
            isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], str)
            for x in v):
        return {k: _jsonable(x) for k, x in v}
    if isinstance(v, tuple):
        return [_jsonable(x) for x in v]
    return v


@dataclass(frozen=True)
class TopologySpec:
    """Frozen description of one topology configuration.

    ``extra`` holds topology-specific parameters beyond ``k``/``seed``
    (e.g. ``rounds`` for 1-peer EquiDyn); it is normalized to a sorted
    tuple of pairs so specs stay hashable and order-insensitive.  A dict
    may be passed in and is converted.
    """
    name: str
    n: int
    k: int | None = None
    seed: int = 0
    extra: tuple = field(default=())

    def __post_init__(self):
        if not isinstance(self.name, str) or not self.name:
            raise ValueError(f"topology name must be a non-empty string, "
                             f"got {self.name!r}")
        if isinstance(self.n, bool) or not isinstance(self.n, int) \
                or self.n < 1:
            raise ValueError(f"n must be a positive int, got {self.n!r}")
        if self.k is not None:
            if isinstance(self.k, bool) or not isinstance(self.k, int):
                raise ValueError(f"k must be an int or None, got {self.k!r}")
            if self.k < 1:
                # explicit, instead of the historical `k or default`
                # falsy-dispatch that silently treated k=0 as "unset"
                raise ValueError(
                    f"k must be >= 1, got {self.k} (omit k, or pass None, "
                    f"to use the topology's registered default)")
        if isinstance(self.seed, bool) or not isinstance(self.seed, int):
            raise ValueError(f"seed must be an int, got {self.seed!r}")
        ex = self.extra
        if isinstance(ex, dict):
            ex = tuple(sorted((str(k), _hashable(v)) for k, v in ex.items()))
        elif isinstance(ex, (list, tuple)):
            pairs = []
            for item in ex:
                if not (isinstance(item, (list, tuple)) and len(item) == 2):
                    raise ValueError(f"extra must be a dict or a sequence of "
                                     f"(key, value) pairs, got {self.extra!r}")
                pairs.append((str(item[0]), _hashable(item[1])))
            ex = tuple(sorted(pairs))
        else:
            raise ValueError(f"extra must be a dict or a sequence of pairs, "
                             f"got {self.extra!r}")
        if len({k for k, _ in ex}) != len(ex):
            raise ValueError(f"duplicate keys in extra: {self.extra!r}")
        object.__setattr__(self, "extra", ex)

    # -- convenience ------------------------------------------------------

    @property
    def label(self) -> str:
        """Human-readable row label: ``name`` or ``name-k<k>``."""
        return self.name + (f"-k{self.k}" if self.k else "")

    @property
    def extra_dict(self) -> dict:
        return {k: _jsonable(v) for k, v in self.extra}

    def get_extra(self, key: str, default=None):
        for k, v in self.extra:
            if k == key:
                return _jsonable(v)
        return default

    def replace(self, **kw) -> "TopologySpec":
        d = self.to_dict()
        d.update(kw)
        return TopologySpec(name=d["name"], n=d["n"], k=d["k"],
                            seed=d["seed"], extra=d["extra"])

    # -- serialization ----------------------------------------------------

    def to_dict(self) -> dict:
        return {"name": self.name, "n": self.n, "k": self.k,
                "seed": self.seed, "extra": self.extra_dict}

    @classmethod
    def from_dict(cls, d: dict) -> "TopologySpec":
        if not isinstance(d, dict):
            raise ValueError(f"spec dict expected, got {type(d).__name__}")
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown spec keys {sorted(unknown)}; "
                             f"expected a subset of {sorted(known)}")
        if "name" not in d or "n" not in d:
            raise ValueError("spec dict requires at least 'name' and 'n'")
        return cls(name=d["name"], n=d["n"], k=d.get("k"),
                   seed=d.get("seed", 0), extra=d.get("extra") or ())

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_json(cls, s: str) -> "TopologySpec":
        return cls.from_dict(json.loads(s))

    def spec_hash(self) -> str:
        """Stable content hash of the canonical JSON form (artifact /
        cache key; NOT Python's per-process ``hash``)."""
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:16]
