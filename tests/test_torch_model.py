"""Layer and model parity: the port (``repro_torch.models``) against the
JAX model zoo on the reduced gemma3-1b, with the reference's weights
carried across by ``convert.params_from_jax``.

Layers, the chunked cross-entropy, and the training loss with its
gradients are compared in f32 at max abs 1e-5 (the same f32 math summed
in another order); the model's logits at max abs 1e-4 (seven layers of
that).  The embedding scale is compared bit for bit, in f32 and bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.ops import KernelConfig
from repro.models import layers as jlayers
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, tree_from_jax
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM

LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
REF = KernelConfig(backend="ref")


def _err(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float32)
                               - np.asarray(want, np.float32))))


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    want = jax_get_config("gemma3-1b")
    got = get_config("gemma3-1b")
    if reduced:
        want, got = want.reduced(), got.reduced()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.num_layers == want.num_layers


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48), dtype=np.float32) * 3.0
    scale = rng.standard_normal(48, dtype=np.float32) * 0.1
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = tlayers.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale))
    assert _err(got, want) <= LAYER_TOL


@pytest.mark.parametrize("theta,pos0", [(1e4, 0), (1e6, 37)])
def test_rope_matches_reference(theta, pos0):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 3, 64), dtype=np.float32)
    pos = pos0 + np.arange(6)
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tlayers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    assert _err(got, want) <= LAYER_TOL


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_mlp_matches_reference(act):
    rng = np.random.default_rng(2)
    d, f = 32, 48
    w = {n: rng.standard_normal(s, dtype=np.float32) * 0.2
         for n, s in (("gate", (d, f)), ("up", (d, f)), ("down", (f, d)))}
    x = rng.standard_normal((2, 4, d), dtype=np.float32)
    want = jlayers.mlp({n: {"w": jnp.asarray(a)} for n, a in w.items()},
                       jnp.asarray(x), act)
    m = tlayers.MLP(d, f, act=act, dtype=torch.float32, device="cpu")
    m.load_state_dict({f"{n}.w": torch.from_numpy(a) for n, a in w.items()})
    assert _err(m(torch.from_numpy(x)), want) <= LAYER_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_scale_matches_reference_bitwise(dtype):
    """``model.py:108-109`` rounds sqrt(d_model) to x's dtype before the
    multiply: in bf16 the constant for d_model=1152 is 34.0, not 33.94."""
    cfg = dataclasses.replace(get_config("gemma3-1b").reduced(),
                              d_model=1152)
    rng = np.random.default_rng(3)
    table = rng.standard_normal((cfg.vocab_size, 1152), dtype=np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (2, 5))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jx = jnp.asarray(table, jdt)[tokens]
    want = np.asarray(jx * jnp.asarray(cfg.d_model ** 0.5, jx.dtype),
                      np.float32)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(table).to(tdt)[torch.from_numpy(tokens)]
    got = (x * torch.tensor(cfg.d_model ** 0.5, dtype=tdt)).float().numpy()
    assert np.array_equal(got, want)
    if dtype == "bfloat16":
        assert np.array_equal(
            got, (x.float() * 34.0).to(tdt).float().numpy())


def _random_norm_scales(params, seed):
    """The reference initialises every norm scale to zero; random scales
    make a swapped or misplaced norm parameter show in the logits."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(0.3 * rng.standard_normal(
            a.shape, dtype=np.float32)) if path[-1].key == "scale" else a,
        params)


def _reduced_pair():
    cfg = get_config("gemma3-1b").reduced()
    jcfg = jax_get_config("gemma3-1b").reduced()
    jparams = _random_norm_scales(
        JM.init(jcfg, jax.random.PRNGKey(0), jnp.float32), 11)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    return cfg, jcfg, jparams, tparams


def test_params_from_jax_splits_stacked_blocks():
    cfg, _, jparams, tparams = _reduced_pair()
    state = tparams.state_dict()
    w = np.asarray(jparams["stack"]["blocks"][2]["attn"]["wq"]["w"])
    assert w.shape[0] == cfg.num_blocks
    for b in range(cfg.num_blocks):
        assert np.array_equal(state[f"stack.blocks.{b}.2.attn.wq.w"].numpy(),
                              w[b])
    assert len(state) == len(jax.tree.leaves(jparams)) + sum(
        cfg.num_blocks - 1 for _ in jax.tree.leaves(jparams["stack"]
                                                    ["blocks"]))


def test_prefill_and_decode_logits_match_reference():
    """Prefill over a prompt longer than the reduced window (4), then four
    decode steps, each against ``M.prefill`` / ``M.decode_step`` with the
    reference's plain attention."""
    cfg, jcfg, jparams, tparams = _reduced_pair()
    B, T, steps = 2, 8, 4
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (B, T + steps))
    jprefill = jax.jit(lambda p, t: JM.prefill(
        jcfg, p, {"tokens": t}, T + steps, jnp.float32, kernel_config=REF))
    jdecode = jax.jit(lambda p, c, t, i: JM.decode_step(
        jcfg, p, c, t, i, kernel_config=REF))
    jl, jc, _ = jprefill(jparams, jnp.asarray(tokens[:, :T]))
    tl, tc = TM.prefill(cfg, tparams, {"tokens": torch.from_numpy(
        tokens[:, :T])}, T + steps, torch.float32)
    assert tl.shape == (B, 1, cfg.vocab_size)
    assert _err(tl, jl) <= MODEL_TOL
    for i in range(T, T + steps):
        jl, jc = jdecode(jparams, jc, jnp.asarray(tokens[:, i:i + 1]),
                         jnp.int32(i))
        tl, tc = TM.decode_step(cfg, tparams, tc,
                                torch.from_numpy(tokens[:, i:i + 1]), i)
        assert _err(tl, jl) <= MODEL_TOL, i


def test_prefill_matches_reference_pallas_interpret():
    """The same prefill against the reference running its TPU kernel in
    interpret mode."""
    cfg, jcfg, jparams, tparams = _reduced_pair()
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, (1, 6))
    jl, _, _ = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(tokens)}, 8,
                          jnp.float32, kernel_config=KernelConfig(
                              backend="pallas", interpret=True))
    tl, _ = TM.prefill(cfg, tparams, {"tokens": torch.from_numpy(tokens)},
                       8, torch.float32)
    assert _err(tl, jl) <= MODEL_TOL


def test_params_from_jax_carries_bf16_bits():
    cfg, _, jparams, _ = _reduced_pair()
    tree = jax.tree.map(lambda a: np.asarray(a).astype(ml_dtypes.bfloat16),
                        jparams)
    model = params_from_jax(tree, cfg, device="cpu", dtype=torch.bfloat16)
    got = model.embed.table.view(torch.uint16).numpy()
    assert np.array_equal(got, tree["embed"]["table"].view(np.uint16))


def test_unported_decode_paths_raise():
    cfg = get_config("gemma3-1b").reduced()
    params = TM.init(cfg, seed=0, device="cpu")
    caches = TM.init_cache(cfg, 1, 8, torch.float32, "cpu")
    tok = torch.zeros(1, 1, dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.decode_step(cfg, params, caches, tok, 3, decode_mode="ring")
    # the paged mode is ported (tests/test_torch_continuous.py); it needs
    # page pools and a block table
    with pytest.raises(ValueError, match="block_table"):
        TM.decode_step(cfg, params, caches, tok, torch.tensor([3]),
                       decode_mode="paged")
    # "append_free" and a (B,) index over a dense cache are ported
    # (tests/test_torch_spec.py); an index of another shape raises
    with pytest.raises(ValueError, match="vector"):
        TM.decode_step(cfg, params, caches, tok, torch.tensor([[3]]))
    # QKV biases (tests/test_torch_zoo.py), MoE and MLA layers
    # (tests/test_torch_moe.py, tests/test_torch_mla.py) are ported;
    # mamba layers are not
    mamba = dataclasses.replace(cfg.pattern[0], kind="mamba")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.Model(dataclasses.replace(cfg, pattern=(mamba,)), device="cpu")


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_chunked_ce_loss_matches_reference(softcap):
    """A ragged last chunk (T = 11, chunk 4) and ignored labels."""
    rng = np.random.default_rng(7)
    h = rng.standard_normal((2, 11, 24), dtype=np.float32)
    w = rng.standard_normal((24, 50), dtype=np.float32)
    labels = rng.integers(0, 50, (2, 11)).astype(np.int32)
    labels[0, 3] = labels[1, -1] = -100
    want = jlayers.chunked_ce_loss(jnp.asarray(h), jnp.asarray(w),
                                   jnp.asarray(labels), chunk=4,
                                   logit_softcap=softcap)
    got = tlayers.chunked_ce_loss(torch.from_numpy(h), torch.from_numpy(w),
                                  torch.from_numpy(labels), chunk=4,
                                  logit_softcap=softcap)
    assert _err(got, want) <= LAYER_TOL


def test_loss_fn_and_gradients_match_reference():
    """``loss_fn`` on a flat dict of tensors, and its gradient by
    autograd, against the reference's ``loss_fn`` and ``jax.grad``."""
    cfg, jcfg, jparams, tparams = _reduced_pair()
    from repro.data.synthetic import token_batches
    batch = token_batches(0, batch=2, seq=12, vocab=cfg.vocab_size)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jax.tree.map(jnp.asarray, batch),
                             kernel_config=REF)[0])(jparams)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in tparams.state_dict().items()}
    loss, aux = TM.loss_fn(cfg, params, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    assert float(aux["aux"]) == 0.0
    assert _err(loss.detach(), jloss) <= LAYER_TOL
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    want = tree_from_jax(jax.tree.map(np.asarray, jgrads))
    assert set(grads) == set(want)
    for k, g in want.items():
        assert _err(grads[k], g) <= LAYER_TOL, k


def test_tree_from_jax_splits_node_stacked_blocks():
    cfg, _, jparams, tparams = _reduced_pair()
    n = 3
    stacked = jax.tree.map(
        lambda a: np.stack([np.asarray(a) * (i + 1) for i in range(n)]),
        jparams)
    got = tree_from_jax({"u": stacked}, node_axis=True)
    state = tparams.state_dict()
    assert set(got) == {f"u.{k}" for k in state}
    for k, v in state.items():
        for i in range(n):
            assert np.array_equal(got[f"u.{k}"][i].numpy(),
                                  v.numpy() * (i + 1)), k
