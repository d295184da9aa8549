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
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_mlp import MLPConfig as JMLPConfig
from repro.data.synthetic import dirichlet_classification
from repro.kernels.ops import KernelConfig
from repro.models import mlp as jmlp
from repro.optim.decentralized import make_method as jmake
from repro.sim.engine import node_stack as jnode_stack
from repro.topology import TopologySpec as JSpec
from repro.topology import build_schedule as jbuild
from repro_torch.convert import tree_from_jax
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


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_method("dsgdm", compression="int8")
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
