"""The port's multi-config sweep (``repro_torch.sim.sweep``) on the CPU.

- ``stack_schedules`` equals the reference's bit for bit (identity
  padding in f32, per-config round indices) and never indexes padding.
- Every (config, seed) cell of a sweep equals its own
  ``simulate_decentralized`` run bit for bit (losses, accuracies,
  consensus, final parameters, clocks), synchronous, under a failure
  model (clocks shared across configs) and compressed, for each method;
  with the padding rounds poisoned with NaN it still does.
- A sweep updates every copy in one grouped call per step
  (``ops.fused_dsgd_steps`` over (C * S * n, ...) tensors, its pre-scale
  each copy's ``diag(W_c)``) and a compressed sweep quantizes every
  copy's reference leaves in one bucketed call per step, each from row
  offset 0.
- The port's sweep against the reference's *single runs* within 1e-5
  (the engine tolerance), synchronous and with the reference's failure
  draws: never against the reference's own sweep bit for bit, whose
  vmapped reductions differ from its single runs in the last bit on some
  CPUs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_mlp import MLPConfig as JMLPConfig
from repro.data.synthetic import dirichlet_classification
from repro.models import mlp as jmlp
from repro.optim.decentralized import make_method as jmake
from repro.sim import FailureModel as JFailureModel
from repro.sim import engine as jengine
from repro.sim import sweep as jsweep
from repro.topology import TopologySpec as JSpec
from repro_torch.compress import CompressionConfig
from repro_torch.convert import tree_from_jax
from repro_torch.core.graphs import TopologySchedule
from repro_torch.kernels import ops
from repro_torch.models import mlp
from repro_torch.optim.decentralized import make_method
from repro_torch.sim import (FailureModel, SweepResult, simulate_decentralized,
                             stack_schedules, sweep_decentralized)
from repro_torch.topology import TopologySpec, as_schedule
from torch_failure_draws import use_reference_draws

N, STEPS, ETA = 8, 20, 0.05
TOPOS = [("base", 1), ("exp", None), ("ring", None)]


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


@pytest.fixture(scope="module")
def setup():
    cfg = JMLPConfig(input_dim=16, hidden=(32,), num_classes=4)
    data = dirichlet_classification(N, 128, dim=16, num_classes=4,
                                    alpha=0.5, margin=0.8, seed=3)
    jseeds = [jmlp.init(cfg, jax.random.PRNGKey(s)) for s in (0, 7)]

    def batches(step, bs=16):
        i = (step * bs) % (128 - bs)
        return data.node_x[:, i:i + bs], data.node_y[:, i:i + bs]

    tx, ty = torch.from_numpy(data.test_x), torch.from_numpy(data.test_y)
    return dict(data=data, jseeds=jseeds, batches=batches,
                seeds=[tree_from_jax(jax.tree.map(np.asarray, p))
                       for p in jseeds],
                eval_fn=lambda p: mlp.accuracy(p, tx, ty))


def _specs():
    return [TopologySpec(name=name, n=N, k=k) for name, k in TOPOS]


def _kw(setup, method, **over):
    kw = dict(loss_fn=mlp.loss_fn, method=method, batches=setup["batches"],
              steps=STEPS, eta=ETA, eval_fn=setup["eval_fn"], eval_every=7,
              device="cpu")
    kw.update(over)
    return kw


def _cells_equal_single_runs(setup, sw: SweepResult, schedules, method,
                             seeds, failure=None):
    for c, sched in enumerate(schedules):
        for s, p in enumerate(seeds):
            ref = simulate_decentralized(**_kw(setup, method, params=p,
                                               schedule=sched,
                                               failure=failure))
            cell = sw.run(c, s)
            np.testing.assert_array_equal(ref.losses, cell.losses)
            np.testing.assert_array_equal(ref.test_acc, cell.test_acc)
            np.testing.assert_array_equal(ref.consensus, cell.consensus)
            np.testing.assert_array_equal(ref.eval_steps, cell.eval_steps)
            for k, x in ref.params.items():
                assert torch.equal(x, cell.params[k]), (c, s, k)
            if failure is None:
                assert cell.clocks is None and sw.clocks is None
            else:
                np.testing.assert_array_equal(ref.clocks, cell.clocks)
    if failure is not None:     # common random numbers: one trace
        assert sw.clocks.shape == (len(schedules), len(seeds), N)
        assert (sw.clocks == sw.clocks[:1, :1]).all()


def test_stack_schedules_matches_reference():
    specs = [("base", 1), ("base", 3), ("one_peer_exp", None),
             ("ring", None)]
    got_W, got_idx = stack_schedules(
        [TopologySpec(name=nm, n=N, k=k) for nm, k in specs], 11,
        device="cpu")
    want_W, want_idx = jsweep.stack_schedules(
        [JSpec(name=nm, n=N, k=k) for nm, k in specs], 11)
    assert np.array_equal(got_W.numpy().view(np.int32),
                          np.asarray(want_W).view(np.int32))
    assert np.array_equal(got_idx.numpy(), np.asarray(want_idx))
    lens = [len(as_schedule(TopologySpec(name=nm, n=N, k=k)))
            for nm, k in specs]
    assert got_W.shape == (4, max(lens), N, N) and len(set(lens)) > 1
    for c, L in enumerate(lens):        # padding rounds are never indexed
        assert int(got_idx[c].max()) < L
        assert torch.equal(got_W[c, L:],
                           torch.eye(N).expand(max(lens) - L, N, N))
    with pytest.raises(ValueError, match="share n"):
        stack_schedules([TopologySpec("ring", N), TopologySpec("ring", N + 1)],
                        4, device="cpu")


CELL_CASES = {
    "dsgdm": ("dsgdm", None, None),
    "dsgdm drop+delay": ("dsgdm", dict(drop_rate=0.25, delay=2, seed=7),
                         None),
    "dsgd int8+EF": ("dsgd", None, CompressionConfig(
        codec="int8", chunk=64, error_feedback=True)),
    "dsgdm fp8": ("dsgdm", None, "fp8"),
    "gt drop": ("gt", dict(drop_rate=0.3, seed=2), None),
    "d2 random": ("d2", dict(byzantine_frac=0.3, byzantine_mode="random",
                             seed=3), None),
    "qg stragglers+churn+all_same": (
        "qg-dsgdm", dict(straggler_rate=0.5, churn_rate=0.1,
                         byzantine_frac=0.2, byzantine_mode="all_same",
                         seed=2), None),
}


@pytest.mark.parametrize("case", list(CELL_CASES))
def test_sweep_cells_equal_single_runs_bitwise(setup, case):
    name, fkw, comp = CELL_CASES[case]
    method = make_method(name, compression=comp)
    failure = None if fkw is None else FailureModel(**fkw)
    sw = sweep_decentralized(**_kw(setup, method, params=setup["seeds"],
                                   schedules=_specs(), failure=failure))
    assert sw.losses.shape == (3, 2, STEPS)
    assert sw.names == [as_schedule(s).label for s in _specs()]
    _cells_equal_single_runs(setup, sw, _specs(), method, setup["seeds"],
                             failure)


def test_padding_is_never_read(setup):
    """Schedules of different period lengths, with their identity
    padding overwritten by NaN (fresh, uncached Schedules): every cell
    still equals its single run."""
    scheds = []
    for name, k in (("base", 1), ("one_peer_exp", None), ("ring", None)):
        built = as_schedule(TopologySpec(name=name, n=N, k=k))
        scheds.append(as_schedule(TopologySchedule(built.name, N,
                                                   list(built.Ws), k=k)))
    Lmax = max(len(s) for s in scheds)
    for s in scheds:
        pad, _ = s.as_padded(STEPS, Lmax, device="cpu")
        pad[len(s):] = float("nan")
        assert s.as_padded(STEPS, Lmax, device="cpu")[0] is pad
    method = make_method("dsgdm")
    failure = FailureModel(drop_rate=0.2, seed=1)
    sw = sweep_decentralized(**_kw(setup, method, params=setup["seeds"][0],
                                   schedules=scheds, failure=failure))
    assert np.isfinite(sw.losses).all()
    _cells_equal_single_runs(setup, sw, scheds, method, setup["seeds"][:1],
                             failure)


def test_sweep_updates_every_copy_in_one_grouped_call(setup, monkeypatch):
    calls, quant = [], []
    real_dsgd, real_quant = ops.fused_dsgd_steps, ops.quantize_payload_many

    def counting_dsgd(xs, us, gs, beta, eta, pre_scale=1.0):
        calls.append((xs[0].shape[0], pre_scale))
        return real_dsgd(xs, us, gs, beta, eta, pre_scale)

    def counting_quant(xs, errs=None, **kw):
        quant.append((len(xs), list(kw["row_offsets"])))
        return real_quant(xs, errs, **kw)

    monkeypatch.setattr(ops, "fused_dsgd_steps", counting_dsgd)
    monkeypatch.setattr(ops, "quantize_payload_many", counting_quant)
    specs = _specs()
    sweep_decentralized(**_kw(setup, make_method("dsgdm"),
                              params=setup["seeds"], schedules=specs))
    assert len(calls) == STEPS and {r for r, _ in calls} == {3 * 2 * N}
    Ws, idx = stack_schedules(specs, STEPS, device="cpu")
    for t, (_, pre) in enumerate(calls):      # diag(W_c), tiled over seeds
        d = torch.stack([torch.diagonal(Ws[c, idx[c, t]])
                         for c in range(3)])
        assert torch.equal(pre, d.repeat_interleave(2, 0).reshape(-1))
    calls.clear()
    sweep_decentralized(**_kw(setup, make_method("dsgd", compression="int8"),
                              params=setup["seeds"], schedules=specs))
    leaves = len(setup["seeds"][0])
    assert calls == [] and len(quant) == STEPS
    assert all(r == (3 * 2 * leaves, [0] * (3 * 2 * leaves)) for r in quant)


def test_sweep_matches_reference_single_runs(setup, monkeypatch):
    """The port's sweep cells against the reference's single runs, 1e-5:
    synchronous over two seeds, and with the reference's failure draws."""
    use_reference_draws(monkeypatch)
    data = setup["data"]
    jmethod = jmake("dsgdm")

    def jbatches(r):
        return tuple(map(jnp.asarray, setup["batches"](r)))

    def jeval(p):
        return jmlp.accuracy(p, jnp.asarray(data.test_x),
                             jnp.asarray(data.test_y))

    fkw = dict(drop_rate=0.25, delay=2, churn_rate=0.05, seed=7)
    for failure, seeds in ((None, (0, 1)), (fkw, (0,))):
        sw = sweep_decentralized(**_kw(
            setup, make_method("dsgdm"),
            params=[setup["seeds"][s] for s in seeds], schedules=_specs(),
            failure=None if failure is None else FailureModel(**failure)))
        for c, (name, k) in enumerate(TOPOS):
            for s in seeds:
                want = jengine.simulate_decentralized(
                    loss_fn=jmlp.loss_fn, params=setup["jseeds"][s],
                    method=jmethod, schedule=JSpec(name, N, k),
                    batches=jbatches, steps=STEPS, eta=ETA, eval_fn=jeval,
                    eval_every=7, failure=None if failure is None
                    else JFailureModel(**failure))
                got = sw.run(c, s)
                np.testing.assert_allclose(got.losses, want.losses, rtol=0,
                                           atol=1e-5)
                np.testing.assert_array_equal(got.test_acc, want.test_acc)
                np.testing.assert_allclose(got.consensus, want.consensus,
                                           rtol=1e-5, atol=0)
                if failure is not None:
                    np.testing.assert_array_equal(got.clocks, want.clocks)


def test_sweep_rejections_and_degenerate_runs(setup):
    kw = _kw(setup, make_method("dsgd"), params=setup["seeds"][0])
    with pytest.raises(ValueError, match="share n"):
        sweep_decentralized(**kw, schedules=[TopologySpec("ring", N),
                                             TopologySpec("ring", N + 1)])
    with pytest.raises(ValueError, match="mixes_per_step"):
        sweep_decentralized(**{**kw, "method": make_method("gt")},
                            schedules=_specs(),
                            failure=FailureModel(delay=1))
    with pytest.raises(ValueError, match="compressed gossip"):
        sweep_decentralized(**{**kw, "method": make_method(
            "dsgd", compression="int8")}, schedules=_specs(),
            failure=FailureModel(drop_rate=0.1))
    empty = sweep_decentralized(**{**kw, "steps": 0}, schedules=_specs())
    assert empty.losses.shape == (3, 1, 0) and empty.clocks is None
    bare = sweep_decentralized(**{**kw, "eval_fn": None, "steps": 5},
                               schedules=_specs()[:2])
    assert bare.losses.shape == (2, 1, 5) and bare.test_acc.shape == (2, 1, 0)
    assert bare.eval_steps.size == 0 and np.isfinite(bare.losses).all()


def test_sim_exports_match_reference(setup):
    import repro.sim as jsim
    import repro_torch.sim as tsim
    want = {k for k in dir(jsim) if not k.startswith("_")
            and not isinstance(getattr(jsim, k), type(jsim))}
    assert want <= set(tsim.__all__)
    got = tsim.stack_batches(setup["batches"], 3, device="cpu")
    ref = jengine.stack_batches(
        lambda r: tuple(map(jnp.asarray, setup["batches"](r))), 3)
    for a, b in zip(got, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))
    W, idx = tsim.materialize_schedule(TopologySpec("base", N, 2), 5,
                                       device="cpu")
    jW, jidx = jengine.materialize_schedule(JSpec("base", N, 2), 5)
    assert np.array_equal(W.numpy(), np.asarray(jW))
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
