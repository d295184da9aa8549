"""The reference's per-round failure draws, in the port's form, for the
failure and sweep parity tests (``tests/test_torch_failure.py``,
``tests/test_torch_sweep.py``).

The reference draws in-graph with ``jax.random`` (``fold_in(PRNGKey(seed),
t)``, then 0 churn, 1 dropout, 2 staleness, 3 Byzantine noise folded per
leaf, ``repro/sim/engine.py:293-331`` and ``failure.py:157-187``); the
port draws every round's values in one function,
``repro_torch.sim.failure.draws``.  Patching that function with
:func:`reference_draws` gives the port the reference's trace.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.sim import failure as tfailure


def _np(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@partial(jax.jit, static_argnums=(2, 3))
def _noise(key, i, shape, mode):
    """Leaf i's attack values: one jitted call per leaf and round (the
    eager draws would dominate a 30-step test)."""
    if mode == "all_same":
        shape = shape[1:]
    return jax.random.normal(jax.random.fold_in(jax.random.fold_in(key, 3),
                                                i), shape, jnp.float32)


def reference_draws(failure, t, n, leaves):
    key = jax.random.fold_in(jax.random.PRNGKey(failure.seed), t)
    out = tfailure.Draws()
    if failure.has_churn:
        out.churn = _np(jax.random.bernoulli(jax.random.fold_in(key, 0),
                                             failure.churn_rate, (n,)))
    if failure.drop_rate > 0.0:
        out.keep = _np(jax.random.bernoulli(jax.random.fold_in(key, 1),
                                            1.0 - failure.drop_rate, (n,)))
    if failure.has_delay:
        out.tau = _np(jax.random.randint(jax.random.fold_in(key, 2), (n,),
                                         0, failure.delay + 1)).long()
    if failure.has_byzantine and failure.byzantine_mode != "sign_flip":
        out.noise = []
        for i, (shape, dtype) in enumerate(leaves):
            assert dtype == torch.float32, dtype
            out.noise.append(_np(_noise(key, i, tuple(shape),
                                        failure.byzantine_mode)))
    return out


def use_reference_draws(monkeypatch):
    monkeypatch.setattr(tfailure, "draws", reference_draws)
