"""The five decentralized methods of the port against the reference's
``method.step`` on the paper MLP: n = 5 nodes on the Base-2 graph
(k = 1), 10 steps, f32.

Both sides start from the reference's node-stacked parameters and get
the same gradients each step: the reference's per-node gradients at its
own parameters, carried across as numpy.  The mixing matrix is each
side's dense stack (equal bit for bit, tests/test_torch_topology.py).
After every step the parameters and every state tree agree within 1e-6
(max abs): the same f32 arithmetic, with the mix summed in another
order.  DSGD-momentum is held against both reference bodies: the fused
one (Pallas in interpret mode, the diag(W) fold the port always uses)
and the default tree-map body (no fold).

Compressed DSGD and DSGD-momentum (int8, fp8, int4 and top-k, with error
feedback on and off) are held to the reference one step at a time: before
each step the port takes the reference's parameters and state
(``convert.state_from_jax``), so both quantize the same half-step values;
parameters, u and the EF residuals then agree within 1e-6 and the step
counter exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_mlp import MLPConfig as JMLPConfig
from repro.data.synthetic import dirichlet_classification
from repro.compress import CompressionConfig as JCompressionConfig
from repro.kernels.ops import KernelConfig
from repro.models import mlp as jmlp
from repro.optim.decentralized import make_method as jmake
from repro.sim.engine import node_stack as jnode_stack
from repro.topology import TopologySpec as JSpec
from repro.topology import build_schedule as jbuild
from repro_torch.convert import state_from_jax, tree_from_jax
from repro_torch.compress import CompressionConfig
from repro_torch.optim.decentralized import METHOD_NAMES, make_method
from repro_torch.topology import TopologySpec, build_schedule

N, K, STEPS, ETA, BS = 5, 1, 10, 0.05, 16
TOL = 1e-6


def _assert_close(got: dict, want_tree, what):
    want = tree_from_jax(jax.tree.map(np.asarray, want_tree),
                         node_axis=True)
    assert set(got) == set(want), what
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        assert err <= TOL, (what, k, err)


@pytest.mark.parametrize("name,ref_config", [
    ("dsgd", None), ("dsgdm", KernelConfig(backend="pallas",
                                           interpret=True)),
    ("dsgdm", KernelConfig(backend="ref")), ("qg-dsgdm", None),
    ("d2", None), ("gt", None)])
def test_method_matches_reference_step_by_step(name, ref_config):
    data = dirichlet_classification(N, STEPS * BS, dim=64, alpha=0.1,
                                    seed=7)
    jparams = jnode_stack(jmlp.init(JMLPConfig(), jax.random.PRNGKey(3)), N)
    jmethod = jmake(name, kernel_config=ref_config)
    method = make_method(name)
    assert method.mixes_per_step == jmethod.mixes_per_step
    jW, _ = jbuild(JSpec(name="base", n=N, k=K)).as_dense_stack(STEPS)
    tW, _ = build_schedule(TopologySpec(name="base", n=N,
                                        k=K)).as_dense_stack(STEPS,
                                                             device="cpu")
    grad_fn = jax.jit(jax.vmap(jax.grad(jmlp.loss_fn)))

    params = tree_from_jax(jax.tree.map(np.asarray, jparams),
                           node_axis=True)
    jstate, state = jmethod.init(jparams), method.init(params)
    for r in range(STEPS):
        sl = slice(r * BS, (r + 1) * BS)
        jgrads = grad_fn(jparams, (jnp.asarray(data.node_x[:, sl]),
                                   jnp.asarray(data.node_y[:, sl])))
        grads = tree_from_jax(jax.tree.map(np.asarray, jgrads),
                              node_axis=True)
        i = r % jW.shape[0]
        jparams, jstate = jmethod.step(jparams, jgrads, jstate, jW[i], ETA)
        params, state = method.step(params, grads, state, tW[i], ETA)
        _assert_close(params, jparams, f"params, step {r}")
        assert set(state) == set(jstate)
        for key in jstate:
            _assert_close(state[key], jstate[key], f"{key}, step {r}")


@pytest.mark.parametrize("error_feedback", [True, False])
@pytest.mark.parametrize("codec", ["int8", "fp8", "int4", "topk"])
@pytest.mark.parametrize("name", ["dsgd", "dsgdm"])
def test_compressed_method_matches_reference_step_by_step(name, codec,
                                                          error_feedback):
    ccfg = dict(codec=codec, chunk=64, topk_frac=0.1,
                error_feedback=error_feedback, seed=2)
    data = dirichlet_classification(N, STEPS * BS, dim=64, alpha=0.1,
                                    seed=7)
    jparams = jnode_stack(jmlp.init(JMLPConfig(), jax.random.PRNGKey(3)), N)
    jmethod = jmake(name, compression=JCompressionConfig(**ccfg))
    method = make_method(name, compression=CompressionConfig(**ccfg))
    assert method.compression == CompressionConfig(**ccfg)
    jW, _ = jbuild(JSpec(name="base", n=N, k=K)).as_dense_stack(STEPS)
    tW, _ = build_schedule(TopologySpec(name="base", n=N,
                                        k=K)).as_dense_stack(STEPS,
                                                             device="cpu")
    grad_fn = jax.jit(jax.vmap(jax.grad(jmlp.loss_fn)))
    jstate = jmethod.init(jparams)
    state = method.init(tree_from_jax(jax.tree.map(np.asarray, jparams),
                                      node_axis=True))
    assert set(state) == set(jstate) and state["ct"] == 0
    for r in range(STEPS):
        sl = slice(r * BS, (r + 1) * BS)
        jgrads = grad_fn(jparams, (jnp.asarray(data.node_x[:, sl]),
                                   jnp.asarray(data.node_y[:, sl])))
        params = tree_from_jax(jax.tree.map(np.asarray, jparams),
                               node_axis=True)
        state = state_from_jax(jax.tree.map(np.asarray, jstate))
        grads = tree_from_jax(jax.tree.map(np.asarray, jgrads),
                              node_axis=True)
        i = r % jW.shape[0]
        jparams, jstate = jmethod.step(jparams, jgrads, jstate, jW[i], ETA)
        params, state = method.step(params, grads, state, tW[i], ETA)
        _assert_close(params, jparams, f"params, step {r}")
        assert set(state) == set(jstate)
        assert state["ct"] == int(jstate["ct"]) == r + 1
        for key in set(jstate) - {"ct"}:
            _assert_close(state[key], jstate[key], f"{key}, step {r}")


@pytest.mark.parametrize("name", ["qg-dsgdm", "d2", "gt"])
def test_compression_guards_match_reference(name):
    for comp in ("int8", CompressionConfig(codec="topk")):
        with pytest.raises(ValueError, match="dsgd/dsgdm"):
            make_method(name, compression=comp)
        with pytest.raises(ValueError, match="dsgd/dsgdm"):
            jmake(name, compression=JCompressionConfig.from_cli(
                comp if isinstance(comp, str) else comp.to_json()))
    for comp in (None, "", "none", "identity", CompressionConfig()):
        method = make_method(name, compression=comp)
        assert method.compression is None and method.name == name


def test_unported_options_raise():
    """Compression with a method other than dsgd/dsgdm raises the
    reference's ValueError; the identity codec is the uncompressed
    method."""
    with pytest.raises(ValueError, match="dsgd/dsgdm"):
        make_method("qg-dsgdm", compression="int8")
    for comp in (None, "identity", "none", "", CompressionConfig()):
        method = make_method("dsgdm", compression=comp)
        assert method.compression is None
        assert set(method.init({"w": torch.zeros(3, 2)})) == {"u"}
    with pytest.raises(ValueError, match="unknown method"):
        make_method("adam")
    assert METHOD_NAMES == ("dsgd", "dsgdm", "qg-dsgdm", "d2", "gt")


def test_dsgdm_folds_the_self_weight_through_the_kernel_pre_scale(
        monkeypatch):
    """The momentum step hands diag(W) to the fused update as per-row
    pre-scales, and mixes with W[i, j] / W[j, j]."""
    from repro_torch.kernels import ops
    seen = []
    real = ops.fused_dsgd_step

    def spy(x, u, g, beta, eta, pre_scale=1.0):
        seen.append(pre_scale)
        return real(x, u, g, beta, eta, pre_scale)

    W = torch.tensor([[0.5, 0.5, 0.0], [0.5, 0.25, 0.25],
                      [0.0, 0.25, 0.75]])
    x = {"w": torch.randn(3, 4)}
    method = make_method("dsgdm")
    monkeypatch.setattr(ops, "fused_dsgd_step", spy)
    new, _ = method.step(x, {"w": torch.zeros(3, 4)}, method.init(x), W,
                         0.1)
    assert torch.equal(seen[0], torch.diagonal(W))
    torch.testing.assert_close(new["w"], W @ x["w"], rtol=1e-6, atol=1e-6)


def test_compressed_dsgdm_half_step_takes_pre_scale_one(monkeypatch):
    """The compressed momentum step runs the fused update with
    pre_scale 1: the diag(W) fold must not reach the payload."""
    from repro_torch.kernels import ops
    seen = []
    real = ops.fused_dsgd_step

    def spy(x, u, g, beta, eta, pre_scale=1.0):
        seen.append(pre_scale)
        return real(x, u, g, beta, eta, pre_scale)

    W = torch.tensor([[0.5, 0.5, 0.0], [0.5, 0.25, 0.25],
                      [0.0, 0.25, 0.75]])
    x = {"w": torch.randn(3, 4), "b": torch.randn(3, 2)}
    method = make_method("dsgdm", compression="int8")
    monkeypatch.setattr(ops, "fused_dsgd_step", spy)
    state = method.init(x)
    ef = state["ef"]
    _, state = method.step(x, {k: torch.zeros_like(v) for k, v in x.items()},
                           state, W, 0.1)
    assert seen == [1.0, 1.0]
    assert state["ct"] == 1 and state["ef"] is ef


def test_compressed_step_takes_a_three_argument_mixer():
    """A mixing callable gets ``(half, ef, ct)`` and returns ``(mixed,
    ef')``, the reference's transport protocol (decentralized.py:193)."""
    x = {"w": torch.randn(3, 4)}
    seen = []

    def mixer(tree, ef, ct):
        seen.append((set(tree), ef, ct))
        return {k: 2 * v for k, v in tree.items()}, {"w": torch.ones(3, 4)}

    method = make_method("dsgd", compression="fp8")
    state = method.init(x)
    new, state = method.step(x, {"w": torch.zeros(3, 4)}, state, mixer, 0.1)
    assert seen[0][0] == {"w"} and seen[0][2] == 0
    assert torch.equal(seen[0][1]["w"], torch.zeros(3, 4))
    assert torch.equal(new["w"], 2 * x["w"]) and state["ct"] == 1
    assert torch.equal(state["ef"]["w"], torch.ones(3, 4))
