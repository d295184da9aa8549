"""Schedule — one topology and its dense artifact (the port's copy of
``repro/topology/schedule.py``).

A :class:`Schedule` wraps the numpy-level ``TopologySchedule`` (the
round-robin sequence of doubly-stochastic mixing matrices) built from a
canonical :class:`TopologySpec`.  The simulation engine consumes
``as_dense_stack(steps, device)``: one period as an ``(L, n, n)``
float32 tensor on the device, plus the per-step round index.  The
distributed runtime consumes ``as_ppermute_plan()``: the rounds compiled
into point-to-point slot plans.  The multi-config sweep consumes
``as_padded(steps, length, device)``: the dense stack padded with
identity rounds to the sweep's common period length.

``build_schedule(spec)`` memoizes whole Schedules by canonical spec, as
the reference does.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from repro_torch.core.graphs import TopologySchedule
from repro_torch.core.ppermute_plan import SchedulePlan, compile_schedule
from repro_torch.device import resolve_device

from .registry import canonicalize, get_registration
from .spec import TopologySpec


class Schedule:
    """A built topology plus its memoized dense stacks (one per device).

    Delegates the ``TopologySchedule`` read API (``n``, ``W(r)``,
    ``len``, ``max_degree``, ...)."""

    def __init__(self, mats: TopologySchedule,
                 spec: TopologySpec | None = None):
        self._mats = mats
        self.spec = spec
        self._dense: dict[torch.device, torch.Tensor] = {}
        self._padded: dict[tuple, torch.Tensor] = {}
        self._plan: SchedulePlan | None = None

    # -- TopologySchedule delegation --------------------------------------

    @property
    def name(self) -> str:
        return self._mats.name

    @property
    def n(self) -> int:
        return self._mats.n

    @property
    def k(self) -> int | None:
        return self._mats.k

    @property
    def Ws(self):
        return self._mats.Ws

    @property
    def finite_time(self) -> bool:
        return self._mats.finite_time

    @property
    def max_degree(self) -> int:
        return self._mats.max_degree

    def W(self, r: int) -> np.ndarray:
        return self._mats.W(r)

    def __len__(self) -> int:
        return len(self._mats)

    def bytes_per_node_per_round(self, param_bytes: int) -> float:
        """Average send-side bytes per node per round for messages of
        ``param_bytes`` (a ``CompressionConfig.wire_bytes`` value)."""
        return self._mats.bytes_per_node_per_round(param_bytes)

    # -- robustness metadata ----------------------------------------------

    def effective_neighbors(self, *, per_round: bool = False) -> float:
        """Effective number of neighbors (Vogels et al.): the full-period
        product's ``n / ||W||_F^2`` (finite-time schedules score exactly
        ``n``), or the mean per-round value with ``per_round=True``."""
        from repro_torch.core.mixing import effective_neighbors
        return effective_neighbors(self._mats, per_round=per_round)

    @property
    def degrades_gracefully(self) -> bool:
        """The registry's degrades-gracefully law for this spec; raw
        (spec-less) schedules report False."""
        if self.spec is None:
            return False
        return bool(get_registration(self.spec.name)
                    .degrades_gracefully(self.spec))

    @property
    def label(self) -> str:
        return self.name + (f"-k{self.k}" if self.k else "")

    def __repr__(self) -> str:
        src = self.spec.to_json() if self.spec else f"name={self.name!r}"
        return f"Schedule({src}, rounds={len(self)})"

    # -- backend artifacts ------------------------------------------------

    def as_dense_stack(self, steps: int, device=None):
        """One period stacked into a dense ``(L, n, n)`` float32 tensor on
        ``device`` (CUDA unless asked), plus the per-step round index
        ``idx[t] = t % L`` as an int64 tensor on the same device.  The
        matrices go through float64 to float32, as the reference's
        (``repro/topology/schedule.py:126-142``) do, so the two stacks are
        equal bit for bit.  The stack is built once per device."""
        dev = resolve_device(device)
        L = max(1, len(self._mats))
        dense = self._dense.get(dev)
        if dense is None:
            dense = torch.from_numpy(
                np.stack([np.asarray(self._mats.W(r), np.float64)
                          for r in range(L)]).astype(np.float32)).to(dev)
            self._dense[dev] = dense
        idx = torch.arange(steps, device=dev) % L
        return dense, idx

    def as_ppermute_plan(self) -> SchedulePlan:
        """Distributed-runtime artifact: the rounds edge-coloured into
        point-to-point slot plans (DESIGN.md Sec. 3), compiled once."""
        if self._plan is None:
            self._plan = compile_schedule(self._mats)
        return self._plan

    def as_padded(self, steps: int, length: int | None = None,
                  device=None):
        """Sweep artifact: the dense stack padded with float32 identity
        rounds to ``length`` (a sweep's common ``Lmax``), built once per
        ``(device, length)``.  Padding rounds are never indexed:
        ``idx[t] = t % L < L <= length``."""
        dev = resolve_device(device)
        W, idx = self.as_dense_stack(steps, dev)
        L = int(W.shape[0])
        length = L if length is None else int(length)
        if length < L:
            raise ValueError(f"cannot pad a {L}-round schedule to "
                             f"length {length}")
        if length == L:
            return W, idx
        pad = self._padded.get((dev, length))
        if pad is None:
            eye = torch.eye(self.n, dtype=torch.float32, device=dev)
            pad = torch.cat([W, eye.expand(length - L, self.n, self.n)])
            self._padded[(dev, length)] = pad
        return pad, idx


@lru_cache(maxsize=512)
def _build_cached(canon: TopologySpec) -> Schedule:
    reg = get_registration(canon.name)
    mats = reg.build(canon)
    # the registry's per-config law is the source of truth for the
    # finite-time attribute, as in the reference
    mats.finite_time = bool(reg.finite_time(canon))
    return Schedule(mats, spec=canon)


def build_schedule(spec: TopologySpec) -> Schedule:
    """Spec -> Schedule, memoized by the canonical spec.  Callers must
    treat the returned Schedule (and its ``Ws``) as immutable."""
    if not isinstance(spec, TopologySpec):
        raise TypeError(f"build_schedule expects a TopologySpec, got "
                        f"{type(spec).__name__}; wrap names with "
                        f"TopologySpec(name=..., n=..., k=...)")
    return _build_cached(canonicalize(spec))


def as_schedule(obj) -> Schedule:
    """Coerce any topology currency to a Schedule: a TopologySpec is
    built (cached), a Schedule passes through, and a raw
    TopologySchedule is wrapped."""
    if isinstance(obj, Schedule):
        return obj
    if isinstance(obj, TopologySpec):
        return build_schedule(obj)
    if isinstance(obj, TopologySchedule):
        return Schedule(obj)
    raise TypeError(
        f"expected TopologySpec | Schedule | TopologySchedule, got "
        f"{type(obj).__name__}")
