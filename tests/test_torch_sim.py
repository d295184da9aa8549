"""The port's simulation engine (``repro_torch.sim.engine``) against the
reference's scan and loop backends, on the CPU.

- The paper MLP, n = 9 on Base-3 (k = 2), Dirichlet alpha = 0.1, each of
  the five methods for 30 steps in f32: per-step losses within 1e-5
  (max abs), accuracies equal, consensus errors within 1e-5 relative.
  Both sides start from the reference's weights; their gradients and
  mixes are the same f32 math summed in another order.
- Reduced gemma3-1b through ``loss_fn``, n = 3 on Base-2, 3 steps of
  DSGD-momentum in f32: losses and final parameters within 1e-4 (max
  abs), the model test's tolerance for a stack of layers.  The
  reference's final parameters come from its own train step
  (``_make_train_step``, what its loop backend runs).
- Compressed gossip through the engine: the paper MLP (n = 9 on Base-3)
  with int8, fp8, int4 and top-k for 30 steps, and reduced gemma3-1b
  (n = 3 on Base-2, DSGD-momentum, int8 with error feedback) for 3
  steps, against the reference's scan backend: losses within 1e-3, the
  tolerance DESIGN.md Sec. 13 gives compressed end-to-end parity (an
  ulp of difference upstream can flip a stochastic-rounding step).  fp8
  is held to 1e-2 (1%, the reference's own int8-vs-uncompressed gate):
  under ``jit`` the reference contracts the residual ``s - q * scale``
  into an FMA, one ulp off the unfused residual that its eager code and
  the port compute, and fp8's residual carries up to 1/16 of each value,
  so flips start by step 3 (a one-ulp change of one weight moves the
  port's own 30-step fp8 losses by 4.2e-4).  Step by step, from the same
  state, the methods agree to 1e-6 (tests/test_torch_decentralized.py).
  The
  gemma case has two pattern blocks, and the reference runs on its own
  stacked tree: the port quantizes each stacked leaf's block tensors
  together, as the reference's leaf (``repro_torch.compress.mixing``).
- The synthetic data of the port's numpy copy equals the reference's
  bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.compress import CompressionConfig as JCompressionConfig
from repro.configs.paper_mlp import MLPConfig as JMLPConfig
from repro.data import synthetic as jsynthetic
from repro.models import mlp as jmlp
from repro.models import model as JM
from repro.optim.decentralized import make_method as jmake
from repro.sim import engine as jengine
from repro.topology import TopologySpec as JSpec
from repro_torch.compress import CompressionConfig
from repro_torch.configs import get_config
from repro_torch.convert import tree_from_jax
from repro_torch.data import synthetic
from repro_torch.models import mlp
from repro_torch.models import model as TM
from repro_torch.optim.decentralized import METHOD_NAMES, make_method
from repro_torch.sim import FailureModel
from repro_torch.sim.engine import simulate_decentralized
from repro_torch.topology import TopologySpec

N, K, STEPS, ETA = 9, 2, 30, 0.03


def _mlp_setup():
    cfg = JMLPConfig(input_dim=32, hidden=(64,), num_classes=10)
    data = jsynthetic.dirichlet_classification(
        N, 256, dim=32, num_classes=10, alpha=0.1, margin=1.0, seed=3)
    jparams = jmlp.init(cfg, jax.random.PRNGKey(0))

    def batches(step, bs=32):
        i = (step * bs) % (256 - bs)
        return data.node_x[:, i:i + bs], data.node_y[:, i:i + bs]

    return data, jparams, batches


@pytest.mark.parametrize("name", METHOD_NAMES)
def test_mlp_simulation_matches_reference_backends(name):
    data, jparams, batches = _mlp_setup()
    tx, ty = torch.from_numpy(data.test_x), torch.from_numpy(data.test_y)
    got = simulate_decentralized(
        loss_fn=mlp.loss_fn,
        params=tree_from_jax(jax.tree.map(np.asarray, jparams)),
        method=make_method(name), schedule=TopologySpec("base", N, K),
        batches=batches, steps=STEPS, eta=ETA,
        eval_fn=lambda p: mlp.accuracy(p, tx, ty), eval_every=10,
        device="cpu")
    for backend in ("scan", "loop"):
        want = jengine.simulate_decentralized(
            loss_fn=jmlp.loss_fn, params=jparams, method=jmake(name),
            schedule=JSpec("base", N, K),
            batches=lambda r: tuple(map(jnp.asarray, batches(r))),
            steps=STEPS, eta=ETA,
            eval_fn=lambda p: jmlp.accuracy(p, jnp.asarray(data.test_x),
                                            jnp.asarray(data.test_y)),
            eval_every=10, backend=backend)
        np.testing.assert_array_equal(got.eval_steps, want.eval_steps)
        np.testing.assert_allclose(got.losses, want.losses, rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(got.test_acc, want.test_acc)
        np.testing.assert_allclose(got.consensus, want.consensus,
                                   rtol=1e-5, atol=0)
    assert got.params["l0.w"].shape == (N, 32, 64)


def test_port_backends_are_one_loop_and_unported_options_raise():
    _, jparams, batches = _mlp_setup()
    kw = dict(loss_fn=mlp.loss_fn,
              params=tree_from_jax(jax.tree.map(np.asarray, jparams)),
              method=make_method("dsgdm"), schedule=TopologySpec("ring", N),
              batches=batches, steps=4, eta=ETA, device="cpu")
    scan = simulate_decentralized(backend="scan", **kw)
    loop = simulate_decentralized(backend="loop", **kw)
    np.testing.assert_array_equal(scan.losses, loop.losses)
    assert scan.test_acc.size == 0 and scan.eval_steps.size == 0
    assert simulate_decentralized(**{**kw, "steps": 0}).losses.size == 0
    # failure models are ported (tests/test_torch_failure.py); as in the
    # reference, only the "scan" name takes them, and the clean model is
    # the synchronous run bit for bit
    with pytest.raises(ValueError, match="scan backend"):
        simulate_decentralized(failure=FailureModel(), **{**kw,
                                                          "backend": "loop"})
    clean = simulate_decentralized(failure=FailureModel(), **kw)
    np.testing.assert_array_equal(clean.losses, scan.losses)
    np.testing.assert_array_equal(clean.clocks, np.full(N, 4))
    assert scan.clocks is None
    with pytest.raises(ValueError, match="backend"):
        simulate_decentralized(backend="vmap", **kw)
    # a compressed method's state rides through the loop
    comp = simulate_decentralized(**{**kw, "method": make_method(
        "dsgdm", compression="int8")})
    assert comp.state["ct"] == 4 and set(comp.state) == {"u", "ct", "ef"}
    assert comp.state["ef"]["l0.w"].dtype == torch.float32


def test_reduced_gemma_training_matches_reference():
    n, steps, eta, B, T = 3, 3, 0.01, 2, 16
    jcfg = jget_config("gemma3-1b").reduced()
    cfg = get_config("gemma3-1b").reduced()
    jparams = JM.init(jcfg, jax.random.PRNGKey(0), jnp.float32)

    def batches(step):
        b = synthetic.token_batches(step, batch=n * B, seq=T,
                                    vocab=cfg.vocab_size)
        return {k: v.reshape(n, B, T) for k, v in b.items()}

    got = simulate_decentralized(
        loss_fn=lambda p, b: TM.loss_fn(cfg, p, b)[0],
        params=tree_from_jax(jax.tree.map(np.asarray, jparams)),
        method=make_method("dsgdm"), schedule=TopologySpec("base", n, 1),
        batches=batches, steps=steps, eta=eta, device="cpu")

    def jloss(p, b):
        return JM.loss_fn(jcfg, p, b)[0]

    jmethod = jmake("dsgdm")
    want = jengine.simulate_decentralized(
        loss_fn=jloss, params=jparams, method=jmethod,
        schedule=JSpec("base", n, 1),
        batches=lambda r: jax.tree.map(jnp.asarray, batches(r)),
        steps=steps, eta=eta)
    np.testing.assert_allclose(got.losses, want.losses, rtol=0, atol=1e-4)

    train_step = jax.jit(jengine._make_train_step(jloss, jmethod, eta))
    sched = JSpec("base", n, 1)
    Ws, _ = jengine.materialize_schedule(sched, steps)
    params_n = jengine.node_stack(jparams, n)
    state = jmethod.init(params_n)
    for r in range(steps):
        params_n, state, _ = train_step(params_n, state, Ws[r % len(Ws)],
                                        jax.tree.map(jnp.asarray,
                                                     batches(r)))
    want_params = tree_from_jax(jax.tree.map(np.asarray, params_n),
                                node_axis=True)
    assert set(got.params) == set(want_params)
    for k, w in want_params.items():
        assert float((got.params[k] - w).abs().max()) <= 1e-4, k


@pytest.mark.parametrize("name,codec", [("dsgdm", "int8"), ("dsgd", "fp8"),
                                        ("dsgdm", "int4"), ("dsgd", "topk")])
def test_compressed_mlp_simulation_matches_reference(name, codec):
    data, jparams, batches = _mlp_setup()
    kw = dict(codec=codec, chunk=64, topk_frac=0.1)
    got = simulate_decentralized(
        loss_fn=mlp.loss_fn,
        params=tree_from_jax(jax.tree.map(np.asarray, jparams)),
        method=make_method(name, compression=CompressionConfig(**kw)),
        schedule=TopologySpec("base", N, K), batches=batches, steps=STEPS,
        eta=ETA, device="cpu")
    want = jengine.simulate_decentralized(
        loss_fn=jmlp.loss_fn, params=jparams,
        method=jmake(name, compression=JCompressionConfig(**kw)),
        schedule=JSpec("base", N, K),
        batches=lambda r: tuple(map(jnp.asarray, batches(r))),
        steps=STEPS, eta=ETA)
    np.testing.assert_allclose(got.losses, want.losses, rtol=0,
                               atol=1e-2 if codec == "fp8" else 1e-3)
    assert got.state["ct"] == STEPS


def test_reduced_gemma_compressed_training_matches_reference():
    n, steps, eta, B, T = 3, 3, 0.01, 2, 16
    jcfg = jget_config("gemma3-1b").reduced(num_blocks=2)
    cfg = get_config("gemma3-1b").reduced(num_blocks=2)
    jparams = JM.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    flat = tree_from_jax(jax.tree.map(np.asarray, jparams))
    ccfg = dict(codec="int8", chunk=256, error_feedback=True, seed=0)

    def batches(step):
        b = synthetic.token_batches(step, batch=n * B, seq=T,
                                    vocab=cfg.vocab_size)
        return {k: v.reshape(n, B, T) for k, v in b.items()}

    got = simulate_decentralized(
        loss_fn=lambda p, b: TM.loss_fn(cfg, p, b)[0], params=flat,
        method=make_method("dsgdm", compression=CompressionConfig(**ccfg)),
        schedule=TopologySpec("base", n, 1), batches=batches, steps=steps,
        eta=eta, device="cpu")
    want = jengine.simulate_decentralized(
        loss_fn=lambda p, b: JM.loss_fn(jcfg, p, b)[0], params=jparams,
        method=jmake("dsgdm", compression=JCompressionConfig(**ccfg)),
        schedule=JSpec("base", n, 1),
        batches=lambda r: jax.tree.map(jnp.asarray, batches(r)),
        steps=steps, eta=eta)
    np.testing.assert_allclose(got.losses, want.losses, rtol=0, atol=1e-3)
    assert got.state["ct"] == steps and set(got.state["ef"]) == set(flat)


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_data_is_the_references(seed):
    got = synthetic.dirichlet_classification(6, 40, dim=16, alpha=0.3,
                                             test_size=50, seed=seed)
    want = jsynthetic.dirichlet_classification(6, 40, dim=16, alpha=0.3,
                                               test_size=50, seed=seed)
    for f in ("node_x", "node_y", "test_x", "test_y"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for step in (0, 3):
        a = synthetic.token_batches(step, batch=4, seq=33, vocab=1000,
                                    seed=seed)
        b = jsynthetic.token_batches(step, batch=4, seq=33, vocab=1000,
                                     seed=seed)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            assert np.array_equal(a[k], b[k]), k
