"""The port's failure-realistic simulation (``repro_torch.sim.failure``
and ``simulate_decentralized(failure=)``) against the reference's, on
the CPU.

- ``FailureModel``: the same validation errors and feature flags; the
  persistent straggler and Byzantine sets bit for bit (numpy draws).
- The building blocks on the same arrays: ``effective_W`` within 1e-6
  of the reference's ``effective_W`` and ``masked_effective_W`` (f32
  against f64) and doubly stochastic; ``participation_mask``,
  ``stale_visible``, ``write_history``, ``init_history``,
  ``select_nodes`` and ``corrupt_visible`` in all three modes equal.
- The engine against the reference's ``simulate_decentralized(failure=)``
  with the reference's random draws patched in
  (``tests/torch_failure_draws.py``): the paper MLP, n = 8, 30 steps, the
  reference's own failure-test setup (``tests/test_failure.py:31-60``),
  every regime under DSGD-momentum and a few under each other method
  (gradient tracking with dropout only): losses within 1e-5, the
  engine tolerance of tests/test_torch_sim.py; accuracies and clocks
  equal.  D2 under dropout diverges (losses past 1e3 by step 30, in the
  reference too), so there an absolute tolerance would measure the
  divergence, not the port: its losses are held to 1e-5 relative above
  a loss of 1 (absolute below), as ``chip_smoke.py``'s
  ``[failure-cpu-vs-card]`` holds them.  Reduced gemma3-1b, n = 3, 3
  steps, delay 1 plus dropout: losses and final parameters within 1e-4
  (the reference's parameters are read through its eval hook).
- The port's own laws: the clean model equals ``failure=None`` bit for
  bit for four methods, and the reference's rejections.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.paper_mlp import MLPConfig as JMLPConfig
from repro.core.mixing import masked_effective_W
from repro.data.synthetic import dirichlet_classification
from repro.models import mlp as jmlp
from repro.models import model as JM
from repro.optim.decentralized import make_method as jmake
from repro.sim import FailureModel as JFailureModel
from repro.sim import engine as jengine
from repro.sim import failure as jfailure
from repro.topology import TopologySpec as JSpec
from repro.topology import build_schedule as jbuild
from repro_torch.configs import get_config
from repro_torch.convert import tree_from_jax
from repro_torch.core.mixing import is_doubly_stochastic
from repro_torch.data import synthetic
from repro_torch.models import mlp
from repro_torch.models import model as TM
from repro_torch.optim.decentralized import make_method
from repro_torch.sim import (BYZANTINE_MODES, FailureModel,
                             check_failure_method, simulate_decentralized)
from repro_torch.sim import failure as tfailure
from repro_torch.topology import TopologySpec
from torch_failure_draws import use_reference_draws

N, STEPS, ETA = 8, 30, 0.05


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tests run thousands of small ops (the engine loops over
    nodes and copies).  Beside the suite's other parallel workers, each
    with torch's default pool of one thread per core, every small op
    waits on an oversubscribed pool: one thread runs this file many
    times faster there, and no slower alone."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

REGIMES = {
    "drop": dict(drop_rate=0.3, seed=1),
    "stragglers": dict(straggler_rate=0.5, straggler_period=3, seed=2),
    "delay": dict(delay=2, seed=3),
    "churn": dict(churn_rate=0.1, seed=4),
    "sign_flip": dict(byzantine_frac=0.25, byzantine_mode="sign_flip",
                      seed=5),
    "random": dict(byzantine_frac=0.25, byzantine_mode="random",
                   byzantine_scale=2.0, seed=6),
    "all_same": dict(byzantine_frac=0.25, byzantine_mode="all_same",
                     seed=7),
    "all four": dict(drop_rate=0.25, delay=2, churn_rate=0.1,
                     byzantine_frac=0.3, byzantine_mode="sign_flip", seed=7),
}
CASES = ([("dsgdm", r) for r in REGIMES]
         + [("dsgd", r) for r in ("drop", "delay")]
         + [("d2", r) for r in ("delay", "churn", "all_same", "drop")]
         + [("qg-dsgdm", r) for r in ("stragglers", "sign_flip")]
         + [("gt", "drop")])
# cases whose losses diverge past 1e3 in both packages
DIVERGING = {("d2", "drop")}


@pytest.fixture(scope="module")
def setup():
    cfg = JMLPConfig(input_dim=16, hidden=(32,), num_classes=4)
    data = dirichlet_classification(N, 128, dim=16, num_classes=4,
                                    alpha=0.5, margin=0.8, seed=3)
    jparams = jmlp.init(cfg, jax.random.PRNGKey(0))

    def batches(step, bs=16):
        i = (step * bs) % (128 - bs)
        return data.node_x[:, i:i + bs], data.node_y[:, i:i + bs]

    tx, ty = torch.from_numpy(data.test_x), torch.from_numpy(data.test_y)
    return dict(data=data, jparams=jparams, batches=batches,
                params=tree_from_jax(jax.tree.map(np.asarray, jparams)),
                eval_fn=lambda p: mlp.accuracy(p, tx, ty))


def _port(setup, method="dsgdm", **over):
    kw = dict(loss_fn=mlp.loss_fn, params=setup["params"],
              method=make_method(method) if isinstance(method, str)
              else method,
              schedule=TopologySpec("base", N, 2), batches=setup["batches"],
              steps=STEPS, eta=ETA, eval_fn=setup["eval_fn"], eval_every=10,
              device="cpu")
    kw.update(over)
    return simulate_decentralized(**kw)


def _reference(setup, method, failure):
    data = setup["data"]
    return jengine.simulate_decentralized(
        loss_fn=jmlp.loss_fn, params=setup["jparams"],
        method=jmake(method), schedule=JSpec("base", N, 2),
        batches=lambda r: tuple(map(jnp.asarray, setup["batches"](r))),
        steps=STEPS, eta=ETA,
        eval_fn=lambda p: jmlp.accuracy(p, jnp.asarray(data.test_x),
                                        jnp.asarray(data.test_y)),
        eval_every=10, failure=failure)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

MODEL_KWARGS = [
    {}, dict(delay=-1), dict(delay=2.0), dict(delay=3),
    dict(drop_rate=1.5), dict(drop_rate=0.2), dict(straggler_rate=-0.1),
    dict(straggler_rate=0.3), dict(straggler_period=1),
    dict(churn_rate=1.0), dict(churn_rate=0.05),
    dict(byzantine_mode="poison"), dict(byzantine_frac=0.2),
    dict(byzantine_frac=0.2, byzantine_mode="random"),
    dict(byzantine_mode="sign_flip"),
]
FLAGS = ("has_drop", "has_delay", "has_churn", "has_byzantine", "is_clean",
         "needs_mixer_closure")


@pytest.mark.parametrize("kw", MODEL_KWARGS, ids=str)
def test_failure_model_validation_and_flags_match_reference(kw):
    try:
        want = JFailureModel(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            FailureModel(**kw)
        assert str(got.value) == str(e)
        return
    got = FailureModel(**kw)
    assert {f: getattr(got, f) for f in FLAGS} \
        == {f: getattr(want, f) for f in FLAGS}
    assert hash(got) == hash(FailureModel(**kw)) and got == FailureModel(**kw)
    assert BYZANTINE_MODES == jfailure.BYZANTINE_MODES


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_persistent_node_sets_match_reference(seed):
    for n in (1, 4, 8, 16, 33):
        for kw in (dict(straggler_rate=0.4),
                   dict(byzantine_frac=0.01, byzantine_mode="sign_flip"),
                   dict(byzantine_frac=0.3, byzantine_mode="random")):
            got, want = FailureModel(seed=seed, **kw), \
                JFailureModel(seed=seed, **kw)
            assert np.array_equal(got.straggler_mask(n),
                                  want.straggler_mask(n))
            assert np.array_equal(got.byzantine_mask(n),
                                  want.byzantine_mask(n))


def test_draws_are_seeded_and_feature_gated():
    leaves = [((4, 3, 2), torch.float32), ((4, 5), torch.bfloat16)]
    fmod = FailureModel(drop_rate=0.3, delay=2, churn_rate=0.2,
                        byzantine_frac=0.3, byzantine_mode="random", seed=4)
    a, b = tfailure.draws(fmod, 7, 4, leaves), tfailure.draws(fmod, 7, 4,
                                                              leaves)
    for f in ("churn", "keep", "tau"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    assert a.tau.dtype == torch.int64 and 0 <= int(a.tau.min()) \
        and int(a.tau.max()) <= 2
    assert [x.shape for x in a.noise] == [(4, 3, 2), (4, 5)]
    assert a.noise[1].dtype == torch.bfloat16
    assert all(torch.equal(x, y) for x, y in zip(a.noise, b.noise))
    other = tfailure.draws(fmod, 8, 4, leaves)
    assert not torch.equal(a.noise[0], other.noise[0])
    same = tfailure.draws(FailureModel(byzantine_frac=0.3,
                                       byzantine_mode="all_same"), 0, 4,
                          leaves)
    assert [x.shape for x in same.noise] == [(3, 2), (5,)]
    clean = tfailure.draws(FailureModel(), 0, 4, leaves)
    assert (clean.churn, clean.keep, clean.tau, clean.noise) \
        == (None, None, None, None)


# ---------------------------------------------------------------------------
# building blocks on the same arrays
# ---------------------------------------------------------------------------

def _rounds():
    out = []
    for name, k in (("base", 2), ("exp", None), ("ring", None),
                    ("d_equistatic", 3)):
        sched = jbuild(JSpec(name=name, n=9, k=k, seed=4))
        out += [np.asarray(W, np.float64) for W in sched.Ws]
    return out


def test_effective_W_matches_reference():
    rng = np.random.default_rng(1)
    for W in _rounds():
        n = W.shape[0]
        for alive in (rng.random(n) < 0.5, rng.random(n) < 0.8,
                      np.ones(n, bool)):
            got = tfailure.effective_W(torch.tensor(W, dtype=torch.float32),
                                       torch.from_numpy(alive))
            want = jfailure.effective_W(jnp.asarray(W, jnp.float32),
                                        jnp.asarray(alive))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(got.numpy(),
                                       masked_effective_W(W, alive),
                                       rtol=0, atol=1e-6)
            assert is_doubly_stochastic(got.double().numpy(), atol=1e-6)


def test_participation_mask_matches_reference():
    n = 12
    for kw in (dict(drop_rate=0.3), dict(straggler_rate=0.5,
                                         straggler_period=3),
               dict(drop_rate=0.2, straggler_rate=0.4), {}):
        got_m, want_m = FailureModel(seed=2, **kw), JFailureModel(seed=2, **kw)
        strag = want_m.straggler_mask(n)
        for t in range(7):
            key = jax.random.PRNGKey(t)
            want = jfailure.participation_mask(want_m, key, t, n, strag)
            keep = torch.from_numpy(np.array(jax.random.bernoulli(
                key, 1.0 - want_m.drop_rate, (n,))))
            got = tfailure.participation_mask(got_m, keep, t, n, strag)
            assert np.array_equal(got.numpy(), np.asarray(want))


def _tree(rng, n):
    return {"a": rng.standard_normal((n, 3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal((n, 5)).astype(np.float32)}}


def _flat(tree):
    return {"a": torch.from_numpy(np.array(tree["a"])),
            "b.c": torch.from_numpy(np.array(tree["b"]["c"]))}


def _same(got: dict, want):
    for k, v in _flat(jax.tree.map(np.asarray, want)).items():
        assert torch.equal(got[k], v), k


def test_history_and_select_match_reference():
    rng = np.random.default_rng(0)
    n, delay = 6, 3
    tree, tree2 = _tree(rng, n), _tree(rng, n)
    jhist = jfailure.init_history(jax.tree.map(jnp.asarray, tree), delay)
    hist = tfailure.init_history(_flat(tree), delay)
    _same(hist, jhist)
    jhist = jfailure.write_history(jhist, jax.tree.map(jnp.asarray, tree2),
                                   1)
    assert tfailure.write_history(hist, _flat(tree2), 1) is hist
    _same(hist, jhist)
    slot = np.array([-1, 0, 1, 2, -1, 1])
    _same(tfailure.stale_visible(_flat(tree), hist, torch.from_numpy(slot)),
          jfailure.stale_visible(jax.tree.map(jnp.asarray, tree), jhist,
                                 jnp.asarray(slot)))
    mask = np.array([True, False, True, True, False, False])
    _same(tfailure.select_nodes(torch.from_numpy(mask), _flat(tree),
                                _flat(tree2)),
          jfailure.select_nodes(jnp.asarray(mask),
                                jax.tree.map(jnp.asarray, tree),
                                jax.tree.map(jnp.asarray, tree2)))


@pytest.mark.parametrize("mode", ["sign_flip", "random", "all_same"])
def test_corrupt_visible_matches_reference(mode):
    rng = np.random.default_rng(5)
    n = 6
    tree = _tree(rng, n)
    want_m = JFailureModel(byzantine_frac=0.4, byzantine_mode=mode,
                           byzantine_scale=3.0, seed=1)
    byz = want_m.byzantine_mask(n)
    key = jax.random.PRNGKey(9)
    want = jfailure.corrupt_visible(want_m, key,
                                    jax.tree.map(jnp.asarray, tree), byz)
    noise = None
    if mode != "sign_flip":     # the reference's draws, per flattened leaf
        leaves = jax.tree.leaves(tree)
        draws = [np.array(jax.random.normal(
            jax.random.fold_in(key, i),
            x.shape if mode == "random" else x.shape[1:], jnp.float32))
            for i, x in enumerate(leaves)]
        noise = {"a": torch.from_numpy(draws[0]),
                 "b.c": torch.from_numpy(draws[1])}
    got = tfailure.corrupt_visible(
        FailureModel(byzantine_frac=0.4, byzantine_mode=mode,
                     byzantine_scale=3.0, seed=1),
        _flat(tree), torch.from_numpy(byz), noise)
    _same(got, want)


# ---------------------------------------------------------------------------
# the engine against the reference, with the reference's draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,regime", CASES)
def test_engine_matches_reference(setup, monkeypatch, method, regime):
    use_reference_draws(monkeypatch)
    want = _reference(setup, method, JFailureModel(**REGIMES[regime]))
    got = _port(setup, method, failure=FailureModel(**REGIMES[regime]))
    np.testing.assert_array_equal(got.eval_steps, want.eval_steps)
    if (method, regime) in DIVERGING:
        scale = np.maximum(1.0, np.abs(want.losses))
        assert np.all(np.abs(got.losses - want.losses) <= 1e-5 * scale)
    else:
        np.testing.assert_allclose(got.losses, want.losses, rtol=0,
                                   atol=1e-5)
    np.testing.assert_array_equal(got.test_acc, want.test_acc)
    np.testing.assert_allclose(got.consensus, want.consensus, rtol=1e-5,
                               atol=0)
    np.testing.assert_array_equal(got.clocks, want.clocks)
    assert got.clocks.shape == (N,)


def test_reduced_gemma_failure_run_matches_reference(monkeypatch):
    """Delay 1 plus dropout on reduced gemma3-1b (n = 3, Base-2, f32,
    DSGD-momentum, 3 steps): losses and final parameters within 1e-4."""
    use_reference_draws(monkeypatch)
    n, steps, eta, B, T = 3, 3, 0.01, 2, 16
    jcfg = jget_config("gemma3-1b").reduced(num_blocks=1)
    cfg = get_config("gemma3-1b").reduced(num_blocks=1)
    jparams = JM.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    kw = dict(delay=1, drop_rate=0.4, seed=2)

    def batches(step):
        b = synthetic.token_batches(step, batch=n * B, seq=T,
                                    vocab=cfg.vocab_size)
        return {k: v.reshape(n, B, T) for k, v in b.items()}

    # the reference returns no parameters: its eval hook sees the
    # node-stacked tree at the eval points (the last step is one)
    seen = []

    def capturing_eval_step(eval_fn):
        def eval_step(params_n):
            jax.debug.callback(lambda p: seen.append(p), params_n)
            return jnp.float32(0.0), jnp.float32(0.0)
        return eval_step

    monkeypatch.setattr(jengine, "_make_eval_step", capturing_eval_step)
    want = jengine.simulate_decentralized(
        loss_fn=lambda p, b: JM.loss_fn(jcfg, p, b)[0], params=jparams,
        method=jmake("dsgdm"), schedule=JSpec("base", n, 1),
        batches=lambda r: jax.tree.map(jnp.asarray, batches(r)),
        steps=steps, eta=eta, eval_fn=lambda p: 0.0, eval_every=steps,
        failure=JFailureModel(**kw))
    got = simulate_decentralized(
        loss_fn=lambda p, b: TM.loss_fn(cfg, p, b)[0],
        params=tree_from_jax(jax.tree.map(np.asarray, jparams)),
        method=make_method("dsgdm"), schedule=TopologySpec("base", n, 1),
        batches=batches, steps=steps, eta=eta, failure=FailureModel(**kw),
        device="cpu")
    np.testing.assert_allclose(got.losses, want.losses, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.clocks, want.clocks)
    assert (got.clocks < steps).any()          # someone dropped
    want_params = tree_from_jax(jax.tree.map(np.asarray, seen[-1]),
                                node_axis=True)
    assert set(got.params) == set(want_params)
    for k, w in want_params.items():
        assert float((got.params[k] - w).abs().max()) <= 1e-4, k


# ---------------------------------------------------------------------------
# the port's own laws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["dsgd", "dsgdm", "qg-dsgdm", "d2"])
def test_clean_model_is_the_synchronous_run_bitwise(setup, method):
    sync = _port(setup, method)
    clean = _port(setup, method, failure=FailureModel())
    np.testing.assert_array_equal(sync.losses, clean.losses)
    np.testing.assert_array_equal(sync.test_acc, clean.test_acc)
    np.testing.assert_array_equal(sync.consensus, clean.consensus)
    for k, x in sync.params.items():
        assert torch.equal(x, clean.params[k]), k
    np.testing.assert_array_equal(clean.clocks, np.full(N, STEPS))
    assert sync.clocks is None


def test_failure_rejections_match_reference(setup):
    for fmod in (FailureModel(delay=2),
                 FailureModel(byzantine_frac=0.2,
                              byzantine_mode="sign_flip")):
        with pytest.raises(ValueError, match="mixes_per_step"):
            _port(setup, "gt", failure=fmod)
    res = _port(setup, "gt", failure=FailureModel(drop_rate=0.2, seed=5))
    assert np.isfinite(res.losses).all() and (res.clocks < STEPS).any()
    with pytest.raises(ValueError, match="compressed gossip"):
        _port(setup, make_method("dsgd", compression="int8"),
              failure=FailureModel(drop_rate=0.1))
    with pytest.raises(ValueError, match="compressed gossip"):
        check_failure_method(FailureModel(),
                             make_method("dsgdm", compression="int8"))
    with pytest.raises(ValueError, match="scan backend"):
        _port(setup, backend="loop", failure=FailureModel(drop_rate=0.1))
    empty = _port(setup, steps=0, failure=FailureModel(drop_rate=0.1))
    assert empty.losses.size == 0 and empty.clocks is None
    # the reference's unused keywords are accepted
    _port(setup, steps=1, same_init=False, key=None)


def test_stragglers_and_churn_semantics(setup):
    fmod = FailureModel(straggler_rate=0.999, straggler_period=5, seed=2)
    assert fmod.straggler_mask(N).all()
    res = _port(setup, failure=fmod, steps=12)
    want = np.array([len([t for t in range(12) if t % 5 == i % 5])
                     for i in range(N)])
    np.testing.assert_array_equal(res.clocks, want)
    churn = _port(setup, failure=FailureModel(churn_rate=0.1, seed=4))
    assert (churn.clocks < STEPS).any() and np.isfinite(churn.losses).all()
    byz = _port(setup, failure=FailureModel(
        byzantine_frac=0.25, byzantine_mode="random", byzantine_scale=100.0,
        seed=6))
    assert np.isfinite(byz.losses).all() and np.isfinite(byz.consensus).all()
