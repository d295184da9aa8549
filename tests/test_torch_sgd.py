"""The plain optimizers (``repro_torch.optim.sgd``) against the
reference's (``repro.optim.sgd``): 10 steps of heavy-ball momentum and of
AdamW (with and without weight decay) in f32 on the same numpy
gradients, each step taken by both from the reference's state after the
step before, the port's result within 4 f32 ulps of the reference's at
every step, an ulp taken at the largest term the element adds.  Not
bit for bit: XLA contracts ``beta * u + g`` and ``x -
eta * u`` into fused multiply-adds, which round once where PyTorch's
eager ops round twice (ROADMAP queue 3, "Summation order and FMAs"); a
step differs by up to an ulp or two, and over a trajectory these
differences add up (6 ulps after 10 momentum steps), so each step starts
from the reference's state."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import sgd as J
from repro_torch.optim import (adamw_init, adamw_update, momentum_init,
                               momentum_update)

STEPS, ULPS = 10, 4
SHAPES = {"w": (16, 24), "b": (24,), "s": ()}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draws(seed):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    return params, grads


def _within_ulps(got: dict, want: dict, terms: dict):
    """``got`` within ULPS f32 ulps of ``want``, an ulp taken at the
    largest magnitude among the terms an element adds (``terms[k]``, a
    list of arrays): a fused multiply-add and two roundings differ by
    ulps of the terms, which a sum that cancels does not shrink."""
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        g = got[k].numpy()
        big = np.max(np.abs(np.stack(
            [np.broadcast_to(np.asarray(t, np.float32), w.shape)
             for t in terms[k]] + [w, g])), axis=0)
        ulp = np.spacing(big)
        assert np.all(np.abs(g - w) <= ULPS * ulp), \
            (k, float(np.max(np.abs(g - w) / ulp)))


def _n(tree):
    return {k: np.array(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("beta", [0.9, 0.0])
def test_momentum_within_4_ulps(beta):
    params, grads = _draws(0)
    assert all(not v.any() for v in momentum_init(_t(params)).values())
    jp, jm = _j(params), J.momentum_init(_j(params))
    step = jax.jit(lambda p, g, m: J.momentum_update(p, g, m, eta=0.05,
                                                      beta=beta))
    for g in grads:
        x0, u0 = _n(jp), _n(jm)
        tp, tm = momentum_update(_t(x0), _t(g), _t(u0), eta=0.05, beta=beta)
        jp, jm = step(jp, _j(g), jm)
        _within_ulps(tm, jm, {k: [beta * u0[k], g[k]] for k in g})
        _within_ulps(tp, jp, {k: [x0[k], 0.05 * np.asarray(jm[k])]
                              for k in g})


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adamw_within_4_ulps(wd):
    params, grads = _draws(1)
    jp, js = _j(params), J.adamw_init(_j(params))
    step = jax.jit(lambda p, g, s: J.adamw_update(p, g, s, eta=1e-2, wd=wd))
    for i, g in enumerate(grads):
        x0, m0, v0 = _n(jp), _n(js["m"]), _n(js["v"])
        tp, ts = adamw_update(_t(x0), _t(g), {
            "m": _t(m0), "v": _t(v0), "t": int(js["t"])}, eta=1e-2, wd=wd)
        jp, js = step(jp, _j(g), js)
        assert ts["t"] == int(js["t"]) == i + 1
        _within_ulps(ts["m"], js["m"], {k: [0.9 * m0[k], 0.1 * g[k]]
                                        for k in g})
        _within_ulps(ts["v"], js["v"], {k: [0.999 * v0[k],
                                            0.001 * g[k] * g[k]]
                                        for k in g})
        m1, v1, t = _n(js["m"]), _n(js["v"]), i + 1
        step_of = {k: 1e-2 * ((m1[k] / (1 - 0.9 ** t))
                              / (np.sqrt(v1[k] / (1 - 0.999 ** t)) + 1e-8)
                              + wd * x0[k]) for k in g}
        _within_ulps(tp, jp, {k: [x0[k], step_of[k]] for k in g})


def test_state_layout():
    p = {"w": torch.zeros(3, dtype=torch.bfloat16)}
    s = adamw_init(p)
    assert s["m"]["w"].dtype == torch.float32 and s["t"] == 0
    assert momentum_init(p)["w"].dtype == torch.bfloat16
