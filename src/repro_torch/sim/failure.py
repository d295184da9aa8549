"""Failure-realistic rounds for the simulation engine (port of
``repro/sim/failure.py``; DESIGN.md Sec. 11).

The paper proves exact finite-time consensus for synchronous,
failure-free rounds.  :class:`FailureModel` is a frozen, hashable
description of how rounds deviate from that model, and the functions
below are the building blocks the engine composes into its step, on
node-stacked flat dicts of tensors:

* **dropout / stragglers**: per-round participation masks; the round's
  matrix is re-normalized (:func:`effective_W`) so it stays doubly
  stochastic over survivors while offline nodes idle on the identity;
* **delayed gossip**: neighbors read a snapshot up to ``delay`` rounds
  old from a ring of past gossiped values (:func:`stale_visible`);
* **churn**: a replaced node restarts its optimizer state and clock;
* **Byzantine nodes**: a persistent subset broadcasts corrupted values
  (``sign_flip`` / ``random`` / ``all_same``) instead of its half-step.

A knob at zero adds nothing to a step, so the all-clean model runs the
synchronous step bit for bit.  The persistent straggler and Byzantine
sets come from numpy generators seeded by the model, as in the
reference.  The per-round draws cannot be the reference's (it draws with
``jax.random``), so they all come from one function, :func:`draws`, of
``(failure, t, n, leaves)``: a CPU ``torch.Generator`` seeded from
``(failure.seed, t, purpose)``.  Every copy of a sweep, and a run on the
CPU or on the card, therefore sees the same failure trace.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

BYZANTINE_MODES = ("none", "sign_flip", "random", "all_same")

# the purposes of the per-round draws (the reference's fold_in indices)
_CHURN, _DROP, _TAU, _NOISE = 0, 1, 2, 3


@dataclass(frozen=True)
class FailureModel:
    """Frozen description of one failure regime."""
    delay: int = 0               # max gossip staleness, in rounds
    drop_rate: float = 0.0       # per-node per-round dropout probability
    straggler_rate: float = 0.0  # fraction of persistently slow nodes
    straggler_period: int = 4    # stragglers participate 1-in-period rounds
    churn_rate: float = 0.0      # per-node per-round replacement probability
    byzantine_frac: float = 0.0  # fraction of persistently Byzantine nodes
    byzantine_mode: str = "none"  # sign_flip | random | all_same
    byzantine_scale: float = 1.0  # amplitude of the random/all_same attacks
    seed: int = 0

    def __post_init__(self):
        if not isinstance(self.delay, int) or self.delay < 0:
            raise ValueError(f"delay must be an int >= 0, got {self.delay!r}")
        for name in ("drop_rate", "straggler_rate", "churn_rate",
                     "byzantine_frac"):
            v = getattr(self, name)
            if not 0.0 <= float(v) < 1.0:
                raise ValueError(f"{name} must be in [0, 1), got {v!r}")
        if self.straggler_period < 2:
            raise ValueError("straggler_period must be >= 2")
        if self.byzantine_mode not in BYZANTINE_MODES:
            raise ValueError(f"byzantine_mode must be one of "
                             f"{BYZANTINE_MODES}, got {self.byzantine_mode!r}")
        if self.byzantine_frac > 0.0 and self.byzantine_mode == "none":
            raise ValueError("byzantine_frac > 0 requires a byzantine_mode")

    @property
    def has_drop(self) -> bool:
        return self.drop_rate > 0.0 or self.straggler_rate > 0.0

    @property
    def has_delay(self) -> bool:
        return self.delay > 0

    @property
    def has_churn(self) -> bool:
        return self.churn_rate > 0.0

    @property
    def has_byzantine(self) -> bool:
        return self.byzantine_frac > 0.0 and self.byzantine_mode != "none"

    @property
    def is_clean(self) -> bool:
        return not (self.has_drop or self.has_delay or self.has_churn
                    or self.has_byzantine)

    @property
    def needs_mixer_closure(self) -> bool:
        """Delay and Byzantine behaviors intercept the values neighbors
        *receive*, which requires the engine to wrap the method's mix in
        a closure (and hence a method that mixes exactly once/step)."""
        return self.has_delay or self.has_byzantine

    # persistent node sets, drawn once from the model's seed ------------

    def straggler_mask(self, n: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, 1))
        return rng.random(n) < self.straggler_rate

    def byzantine_mask(self, n: int) -> np.ndarray:
        if not self.has_byzantine:
            return np.zeros(n, bool)
        rng = np.random.default_rng((self.seed, 2))
        mask = rng.random(n) < self.byzantine_frac
        if not mask.any():                 # frac > 0 means at least one
            mask[int(rng.integers(n))] = True
        return mask


# ---------------------------------------------------------------------------
# the per-round draws
# ---------------------------------------------------------------------------

@dataclass
class Draws:
    """One round's random draws, CPU tensors; a field is None when its
    feature is off."""
    churn: torch.Tensor | None = None   # (n,) bool: replaced this round
    keep: torch.Tensor | None = None    # (n,) bool: survives dropout
    tau: torch.Tensor | None = None     # (n,) int64: staleness in rounds
    noise: list | None = None           # per reference leaf: attack values


def _generator(*words: int) -> torch.Generator:
    seed = np.random.SeedSequence(list(words)).generate_state(1)[0]
    return torch.Generator().manual_seed(int(seed))


def draws(failure: FailureModel, t: int, n: int, leaves) -> Draws:
    """All of round ``t``'s random draws for ``n`` nodes, on the CPU.

    ``leaves`` lists the model's leaves as the reference flattens them
    (``(shape, dtype)``, shapes node-stacked); the ``random`` and
    ``all_same`` attacks draw one normal tensor per leaf, of the leaf's
    shape (``random``: independent per node) or of one node's
    (``all_same``: a vector every Byzantine node shares), unscaled."""
    out = Draws()
    if failure.has_churn:
        out.churn = torch.rand(n, generator=_generator(
            failure.seed, t, _CHURN)) < failure.churn_rate
    if failure.drop_rate > 0.0:
        out.keep = torch.rand(n, generator=_generator(
            failure.seed, t, _DROP)) < 1.0 - failure.drop_rate
    if failure.has_delay:
        out.tau = torch.randint(0, failure.delay + 1, (n,),
                                generator=_generator(failure.seed, t, _TAU))
    if failure.has_byzantine and failure.byzantine_mode != "sign_flip":
        out.noise = []
        for i, (shape, dtype) in enumerate(leaves):
            if failure.byzantine_mode == "all_same":
                shape = shape[1:]
            out.noise.append(torch.randn(
                tuple(shape), generator=_generator(failure.seed, t, _NOISE, i)
            ).to(dtype))
    return out


# ---------------------------------------------------------------------------
# building blocks (composed by repro_torch.sim.engine)
# ---------------------------------------------------------------------------

def _rows(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (ndim - 1))


def effective_W(W: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Torch twin of :func:`repro_torch.core.mixing.masked_effective_W`,
    in W's dtype, with the reference's operations in the reference's
    order (``repro/sim/failure.py:130-146``): no data-dependent control
    flow, so with ``alive`` all ones it returns ``W`` up to exact float
    ops (multiply by 1.0, add 0.0)."""
    a = alive.to(W.dtype)
    Weff = W * a[:, None] * a[None, :] + torch.diag(1.0 - a)
    r = a * (1.0 - Weff.sum(dim=1))
    c = a * (1.0 - Weff.sum(dim=0))
    d = torch.minimum(r, c)
    Weff = Weff + torch.diag(d)
    r = r - d
    c = c - d
    s = r.sum()
    scale = torch.where(s > 1e-12, 1.0 / torch.where(s > 1e-12, s, 1.0), 0.0)
    return Weff + scale * torch.outer(r, c)


def participation_mask(failure: FailureModel, keep, t: int, n: int,
                       stragglers: np.ndarray) -> torch.Tensor:
    """(n,) bool: which nodes take part in round ``t``.  ``keep`` is the
    round's dropout draw (:attr:`Draws.keep`); a persistent straggler
    additionally participates only on its own 1-in-period phase (phases
    staggered by node id so stragglers never synchronize)."""
    active = torch.ones(n, dtype=torch.bool)
    if failure.drop_rate > 0.0:
        active = keep
    if failure.straggler_rate > 0.0:
        p = failure.straggler_period
        slow_ok = (t % p) == torch.arange(n) % p
        active = active & (slow_ok | ~torch.from_numpy(stragglers))
    return active


def corrupt_visible(failure: FailureModel, tree: dict, byz: torch.Tensor,
                    noise: dict | None = None) -> dict:
    """The values the Byzantine nodes broadcast in place of ``tree``'s:
    ``byz`` is the (nodes,) membership mask, ``noise`` the round's
    attack values per key (:func:`draws`, of the tensor's shape for
    ``random``, of one node's for ``all_same``).  Honest nodes' entries
    pass through untouched."""
    mode, scale = failure.byzantine_mode, failure.byzantine_scale
    out = {}
    for k, x in tree.items():
        m = _rows(byz, x.ndim)
        if mode == "sign_flip":
            out[k] = torch.where(m, -x, x)
        else:       # random: per node; all_same: one shared vector
            out[k] = torch.where(m, (scale * noise[k]).expand(x.shape), x)
    return out


def stale_visible(tree: dict, hist: dict, slot: torch.Tensor) -> dict:
    """Bounded-staleness read: for each node j, the value neighbors see
    is either j's current contribution (``slot[j] < 0``) or its entry in
    history ring slot ``slot[j]``."""
    fresh = slot < 0
    idx = torch.where(fresh, 0, slot)
    nodes = torch.arange(slot.shape[0], device=slot.device)
    return {k: torch.where(_rows(fresh, x.ndim), x, hist[k][idx, nodes])
            for k, x in tree.items()}


def write_history(hist: dict, tree: dict, slot: int) -> dict:
    """Write this round's gossiped tree into ring slot ``slot``, in place
    (at full width a second ring would not fit beside the first)."""
    for k, x in tree.items():
        hist[k][slot].copy_(x)
    return hist


def init_history(params_n: dict, delay: int) -> dict:
    """(delay, nodes, ...) ring primed with the initial parameters:
    before real history exists, maximally stale reads see the init."""
    return {k: x.unsqueeze(0).expand((delay,) + x.shape).clone()
            for k, x in params_n.items()}


def select_nodes(mask: torch.Tensor, new_tree, old_tree):
    """Per-node select on every tensor's leading axis of a flat dict (or
    a method state, a dict of them): ``mask`` True takes ``new_tree``."""
    if isinstance(new_tree, dict):
        return {k: select_nodes(mask, v, old_tree[k])
                for k, v in new_tree.items()}
    return torch.where(_rows(mask, new_tree.ndim), new_tree, old_tree)
