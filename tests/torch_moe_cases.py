"""Reduced models against the JAX reference on the CPU, shared by
``tests/test_torch_moe.py`` (grok-1-314b), ``tests/test_torch_mla.py``
(deepseek-v3-671b), ``tests/test_torch_mamba2.py`` (mamba2-2.7b,
jamba-1.5-large-398b), ``tests/test_torch_vlm.py`` (llava-next-34b) and
``tests/test_torch_encdec.py`` (seamless-m4t-large-v2): each arch's
``reduced()`` config with the
reference's weights carried across by ``convert.params_from_jax``, the
leaves that start at a constant made random (norm scales, and a Mamba
layer's ``A_log``, ``D``, ``dt_bias`` and ``conv_b``).  The reference
runs through ``M.*`` with its plain attention; its gradient is compiled
once per arch.  A frontend model's stub embeddings (``frames`` or
``prefix_embeds``) are drawn with numpy (:func:`stubs`) and given to both
sides.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.data import synthetic as jsynthetic
from repro.kernels.ops import KernelConfig
from repro.models import model as JM
from repro.optim.decentralized import make_method as jmake
from repro.sim import engine as jengine
from repro.topology import TopologySpec as JSpec
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, tree_from_jax
from repro_torch.models import model as TM
from repro_torch.optim.decentralized import make_method
from repro_torch.sim.engine import simulate_decentralized
from repro_torch.topology import TopologySpec

LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
REF = KernelConfig(backend="ref")
#: leaves initialised to a constant, drawn at random for the parity runs
CONSTANT_LEAVES = ("scale", "A_log", "D", "dt_bias", "conv_b")
#: archs whose reference weights are drawn with numpy over the shapes of
#: ``jax.eval_shape(JM.init)``, at the reference's scales (N(0, 0.02),
#: ``conv_w`` N(0, 0.1)): compiling ``JM.init`` costs ~7 s for reduced
#: jamba on the CPU
NUMPY_INIT = ("mamba2-2.7b", "jamba-1.5-large-398b", "llava-next-34b",
              "seamless-m4t-large-v2")


def stubs(cfg, batch, length, seed):
    """A frontend model's stub inputs as numpy, N(0, 1) x 0.02 in f32 as
    the reference's stubs: ``{"frames": (batch, length, d)}`` (audio),
    ``{"prefix_embeds": ...}`` (vision), or ``{}``."""
    key = {"audio": "frames", "vision": "prefix_embeds"}.get(cfg.frontend)
    if key is None or not length:
        return {}
    rng = np.random.default_rng(seed)
    return {key: 0.02 * rng.standard_normal((batch, length, cfg.d_model),
                                            dtype=np.float32)}


def err(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float32)
                               - np.asarray(want, np.float32))))


@functools.lru_cache(maxsize=None)
def pair(arch):
    """The reference's reduced params (``CONSTANT_LEAVES`` random) and the
    port's model holding them."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    rng = np.random.default_rng(11)
    if arch in NUMPY_INIT:
        def draw(path, a):
            key = path[-1].key
            if key in CONSTANT_LEAVES:
                return jnp.full(a.shape, 1.0 if key == "D" else 0.0)
            scale = 0.1 if key == "conv_w" else 0.02
            return jnp.asarray(scale * rng.standard_normal(
                a.shape, dtype=np.float32))

        jparams = jax.tree_util.tree_map_with_path(draw, jax.eval_shape(
            lambda k: JM.init(jcfg, k, jnp.float32), jax.random.PRNGKey(0)))
    else:
        jparams = jax.jit(JM.init, static_argnums=(0, 2))(
            jcfg, jax.random.PRNGKey(0), jnp.float32)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(0.3 * rng.standard_normal(
            a.shape, dtype=np.float32))
        if path[-1].key in CONSTANT_LEAVES else a, jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    return jcfg, cfg, jparams, tparams


def prefill_decode(arch):
    """Prefill 7 tokens, three decode steps, then a (B,) verify window of
    3 rows at per-request positions, each against the reference."""
    jcfg, cfg, jparams, tparams = pair(arch)
    B, P, steps, T = 2, 7, 3, 3
    S = P + steps + T + 2
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                               (B, P + steps + T))
    jl, jc, _ = jax.jit(lambda p, t: JM.prefill(
        jcfg, p, {"tokens": t}, S, jnp.float32, kernel_config=REF))(
        jparams, jnp.asarray(tokens[:, :P]))
    with torch.inference_mode():
        tl, tc = TM.prefill(cfg, tparams, {"tokens": torch.from_numpy(
            tokens[:, :P])}, S, torch.float32)
    assert tl.shape == (B, 1, cfg.vocab_size)
    assert err(tl, jl) <= MODEL_TOL
    jdecode = jax.jit(lambda p, c, t, i: JM.decode_step(
        jcfg, p, c, t, i, kernel_config=REF))
    for i in range(P, P + steps):
        jl, jc = jdecode(jparams, jc, jnp.asarray(tokens[:, i:i + 1]),
                         jnp.int32(i))
        with torch.inference_mode():
            tl, tc = TM.decode_step(cfg, tparams, tc,
                                    torch.from_numpy(tokens[:, i:i + 1]), i)
        assert err(tl, jl) <= MODEL_TOL, i
    # the verify window: request 1 one position behind request 0
    at = P + steps
    idx = np.array([at, at - 1], np.int32)
    win = tokens[:, at:at + T]
    jl, jc = jdecode(jparams, jc, jnp.asarray(win), jnp.asarray(idx))
    with torch.inference_mode():
        tl, tc = TM.decode_step(cfg, tparams, tc, torch.from_numpy(win),
                                torch.from_numpy(idx).long())
    assert tl.shape == (B, T, cfg.vocab_size)
    assert err(tl, jl) <= MODEL_TOL
    return jc, tc


@functools.lru_cache(maxsize=None)
def _jprefill(arch, max_seq):
    jcfg = pair(arch)[0]
    return jax.jit(lambda p, b: JM.prefill(jcfg, p, b, max_seq, jnp.float32,
                                           kernel_config=REF))


def prefill_decode_stub(arch, stub_len, decode_mode, P=7, steps=2):
    """A frontend model served against the reference: prefill of ``P``
    tokens after ``stub_len`` prefix embeddings (vision) or over
    ``stub_len`` encoder frames (audio), then ``steps`` one-token
    ``decode_step``s in ``decode_mode`` at ``prefix + P + i``.  The
    prefill logits, every K/V cache row and the encoder output (which the
    port keeps in its caches, the reference returns beside them) are held
    at 1e-4, 1e-5 for the encoder output, and each step's logits at
    1e-4."""
    jcfg, cfg, jparams, tparams = pair(arch)
    B = 2
    extra = stubs(cfg, B, stub_len, 6)
    npfx = stub_len if cfg.frontend == "vision" else 0
    S = npfx + P + steps + 1
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                               (B, P + steps))
    jl, jc, jenc = _jprefill(arch, S)(jparams, {
        "tokens": jnp.asarray(tokens[:, :P]),
        **{k: jnp.asarray(v) for k, v in extra.items()}})
    with torch.inference_mode():
        tl, tc = TM.prefill(cfg, tparams, {
            "tokens": torch.from_numpy(tokens[:, :P]),
            **{k: torch.from_numpy(v) for k, v in extra.items()}}, S,
            torch.float32)
    assert tl.shape == (B, 1, cfg.vocab_size)
    assert err(tl, jl) <= MODEL_TOL
    assert (jenc is None) == ("enc_out" not in tc)
    if jenc is not None:
        assert tc["enc_out"].shape == (B, stub_len, cfg.d_model)
        assert err(tc["enc_out"], jenc) <= LAYER_TOL
    for pos in range(len(cfg.pattern)):
        for b, block in enumerate(tc["blocks"]):
            for n in ("k", "v"):
                assert err(block[pos]["attn"][n],
                           jc["blocks"][pos]["attn"][n][b]) <= MODEL_TOL
    jdecode = jax.jit(lambda p, c, t, i, e: JM.decode_step(
        jcfg, p, c, t, i, e, decode_mode=decode_mode, kernel_config=REF))
    for i in range(P, P + steps):
        tok = tokens[:, i:i + 1]
        jl, jc = jdecode(jparams, jc, jnp.asarray(tok), jnp.int32(npfx + i),
                         jenc)
        with torch.inference_mode():
            tl, tc = TM.decode_step(cfg, tparams, tc, torch.from_numpy(tok),
                                    npfx + i, decode_mode=decode_mode)
        assert tl.shape == (B, 1, cfg.vocab_size)
        assert err(tl, jl) <= MODEL_TOL, i
    return tc


@functools.lru_cache(maxsize=None)
def _jvalue_and_grad(arch):
    """The reference's ``loss_fn`` and its gradient, jitted once per arch
    (the loss test and the simulation step share the compile)."""
    jcfg = pair(arch)[0]
    return jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(jcfg, p, b, kernel_config=REF),
        has_aux=True))


def loss_and_grads(arch, seq=12, stub_len=0):
    """``loss_fn`` (with the aux loss, and deepseek's MTP term through its
    untied head) and every gradient against ``jax.value_and_grad``, on 2
    sequences of ``seq`` tokens, with ``stub_len`` frames or prefix
    embeddings each for a frontend model."""
    _, cfg, jparams, tparams = pair(arch)
    batch = jsynthetic.token_batches(0, batch=2, seq=seq,
                                     vocab=cfg.vocab_size)
    batch.update(stubs(cfg, 2, stub_len, 9))
    (jloss, jaux), jgrads = _jvalue_and_grad(arch)(
        jparams, jax.tree.map(jnp.asarray, batch))
    params = {k: v.detach().clone().requires_grad_()
              for k, v in tparams.state_dict().items()}
    loss, aux = TM.loss_fn(cfg, params, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    assert (float(aux["aux"].detach()) > 0.0) == (cfg.moe is not None)
    assert err(aux["aux"].detach(), jaux["aux"]) <= LAYER_TOL
    assert err(loss.detach(), jloss) <= LAYER_TOL
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    want = tree_from_jax(jax.tree.map(np.asarray, jgrads))
    assert set(grads) == set(want)
    for k, g in want.items():
        assert err(grads[k], g) <= LAYER_TOL, k
    return grads


def sim_step(arch, T=12, stub_len=0):
    """One DSGD-momentum step of n = 3 nodes on Base-2 through the port's
    ``simulate_decentralized`` against the reference engine's step
    (``sim/engine.py:121-129``: each node's loss and gradients, their
    mean loss, then ``method.step``), node by node through the compiled
    gradient of the loss test, on 2 sequences of ``T`` tokens per node
    (and ``stub_len`` frames or prefix embeddings each, (n, 2, stub_len,
    d) in the batch dict): the loss and every parameter."""
    _, cfg, jparams, _ = pair(arch)
    n, eta, B = 3, 0.05, 2

    def batches(step):
        b = jsynthetic.token_batches(step, batch=n * B, seq=T,
                                     vocab=cfg.vocab_size)
        b = {k: v.reshape(n, B, T) for k, v in b.items()}
        for k, v in stubs(cfg, n * B, stub_len, 100 + step).items():
            b[k] = v.reshape((n, B) + v.shape[1:])
        return b

    got = simulate_decentralized(
        loss_fn=lambda p, b: TM.loss_fn(cfg, p, b)[0],
        params=tree_from_jax(jax.tree.map(np.asarray, jparams)),
        method=make_method("dsgdm"), schedule=TopologySpec("base", n, 2),
        batches=batches, steps=1, eta=eta, device="cpu")
    jmethod = jmake("dsgdm")
    Ws, _ = jengine.materialize_schedule(JSpec("base", n, 2), 1)
    batch = batches(0)
    per_node = [_jvalue_and_grad(arch)(jparams, {k: jnp.asarray(v[i])
                                                 for k, v in batch.items()})
                for i in range(n)]
    loss = np.mean([float(lv[0]) for lv, _ in per_node])
    grads = jax.tree.map(lambda *g: jnp.stack(g), *[g for _, g in per_node])
    params_n = jengine.node_stack(jparams, n)
    params_n, _ = jax.jit(lambda p, g, s, W: jmethod.step(p, g, s, W, eta))(
        params_n, grads, jmethod.init(params_n), Ws[0])
    assert abs(float(got.losses[0]) - loss) <= LAYER_TOL
    want = tree_from_jax(jax.tree.map(np.asarray, params_n), node_axis=True)
    assert set(got.params) == set(want)
    for k, w in want.items():
        assert err(got.params[k], w) <= LAYER_TOL, k
