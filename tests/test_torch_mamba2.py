"""The SSM family in the port (``repro_torch.models.mamba2``; mamba2-2.7b
and the hybrid jamba-1.5-large-398b) against the JAX reference, on the
CPU, in f32.

- The SSD core: ``ssd_chunked`` with and without an initial state,
  ``ssd_step`` and the causal depthwise conv against the reference's at
  max abs 1e-5; the chunked scan against the step recurrence, as the
  reference's ``tests/test_models_smoke.py:108-127`` does.
- The overflow case: with chunk 16, A = -1 and dt = 8 or 12 a chunk's
  decay passes ~88, and the reference's ``dL/d dt`` is not finite (it
  takes ``exp`` before the causal mask); the port's gradients are finite
  and its ``dL/dx`` equals the reference's.
- The ``Mamba`` layer against ``mamba_apply`` on random leaves: without
  a cache, a prefill and a T > 1 continuation from a random state, and a
  one-token step; the output and the updated cache at 1e-5.
- Reduced mamba2-2.7b and jamba-1.5-large-398b (the reference's weights,
  constant leaves made random): prefill and decode logits and a (B,)
  verify window against ``M.prefill`` / ``M.decode_step`` at 1e-4, then
  an append-free step that advances the Mamba state as the reference's;
  ``loss_fn`` (jamba's with the aux loss) and every gradient against
  ``jax.value_and_grad`` at 1e-5; one DSGD-momentum step of the
  simulation engine on mamba2; jamba's leaves split along the blocks
  and stack back to the reference's tree bit for bit.
- A prompt that is not a multiple of the chunk raises; paged caches, the
  continuous engine and speculation raise for both archs; both configs
  equal the reference's field by field, full and reduced.

Torch runs on one intra-op thread, and each reference function is jitted
once per arch (``torch_moe_cases``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_moe_cases as cases
from repro.configs import get_config as jget_config
from repro.models import mamba2 as jmamba
from repro.models import model as JM
from repro_torch.configs import ARCH_NAMES, SSMConfig, get_config
from repro_torch.convert import tree_from_jax
from repro_torch.models import mamba2 as tmamba
from repro_torch.models.blocks import layer_caches
from repro_torch.models import model as TM
from repro_torch.serve import ContinuousEngine, PagedCacheLayout, make_engine
from torch_moe_cases import LAYER_TOL, MODEL_TOL, err

ARCHS = ("mamba2-2.7b", "jamba-1.5-large-398b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _ssd_inputs(seed, b=2, t=32, h=3, p=4, n=5):
    """Inputs at a layer's scale: dt near softplus(0) = 0.69, B and C of
    a SiLU's magnitude."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return scale * rng.standard_normal(shape, dtype=np.float32)

    return dict(x=normal(b, t, h, p), dt=np.abs(normal(b, t, h)) + 0.1,
                A=-np.exp(normal(h, scale=0.5)), B=normal(b, t, n, scale=0.5),
                C=normal(b, t, n, scale=0.5), S=normal(b, h, p, n))


# ---------------------------------------------------------------------------
# the SSD core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(with_state):
    i = _ssd_inputs(1)
    init = i["S"] if with_state else None
    args = [i[k] for k in "x dt A B C".split()]
    jy, jS = jax.jit(jmamba.ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, args), 8,
        None if init is None else jnp.asarray(init))
    ty, tS = tmamba.ssd_chunked(*map(_t, args), 8,
                                None if init is None else _t(init))
    assert ty.dtype == torch.float32 and tS.dtype == torch.float32
    assert err(ty, jy) <= LAYER_TOL and err(tS, jS) <= LAYER_TOL


def test_ssd_step_matches_reference():
    i = _ssd_inputs(2)
    args = (i["S"], i["x"][:, 0], i["dt"][:, 0], i["A"], i["B"][:, 0],
            i["C"][:, 0])
    jS, jy = jmamba.ssd_step(*map(jnp.asarray, args))
    tS, ty = tmamba.ssd_step(*map(_t, args))
    assert err(tS, jS) <= LAYER_TOL and err(ty, jy) <= LAYER_TOL


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 6), dtype=np.float32)
    w = rng.standard_normal((4, 6), dtype=np.float32)
    b = rng.standard_normal(6, dtype=np.float32)
    want = jmamba._causal_depthwise_conv(*map(jnp.asarray, (x, w, b)))
    got = tmamba.causal_depthwise_conv(*map(_t, (x, w, b)))
    assert got.shape == (2, 9, 6) and err(got, want) <= LAYER_TOL


def test_chunked_scan_equals_the_step_recurrence():
    """The chunked scan over 32 positions (chunk 8) against 32 steps, and
    a scan resumed from the state half-way against one over the whole
    sequence."""
    i = {k: _t(v) for k, v in _ssd_inputs(4).items()}
    y, S = tmamba.ssd_chunked(i["x"], i["dt"], i["A"], i["B"], i["C"], 8)
    s = torch.zeros_like(i["S"])
    ys = []
    for t in range(i["x"].shape[1]):
        s, yt = tmamba.ssd_step(s, i["x"][:, t], i["dt"][:, t], i["A"],
                                i["B"][:, t], i["C"][:, t])
        ys.append(yt)
    assert err(torch.stack(ys, 1), y) <= LAYER_TOL
    assert err(s, S) <= LAYER_TOL
    half = [v[:, :16] for v in (i["x"], i["dt"])]
    _, S16 = tmamba.ssd_chunked(*half, i["A"], i["B"][:, :16],
                                i["C"][:, :16], 8)
    y2, S2 = tmamba.ssd_chunked(i["x"][:, 16:], i["dt"][:, 16:], i["A"],
                                i["B"][:, 16:], i["C"][:, 16:], 8, S16)
    assert err(y2, y[:, 16:]) <= LAYER_TOL and err(S2, S) <= LAYER_TOL


@pytest.mark.parametrize("dt", [0.5, 8.0, 12.0])
def test_scan_gradients_finite_where_the_reference_overflows(dt):
    """Chunk 16, A = -1, constant dt: at dt = 8 and 12 a chunk's decay
    sum passes ~88 and the reference's ``dL/d dt`` is NaN or inf; the
    port masks before the exponent, so its gradients are finite, and
    its forward and ``dL/dx`` equal the reference's."""
    rng = np.random.default_rng(5)
    t, q = 32, 16
    x = rng.standard_normal((1, t, 2, 4), dtype=np.float32)
    B = rng.standard_normal((1, t, 3), dtype=np.float32)
    C = rng.standard_normal((1, t, 3), dtype=np.float32)
    cot = rng.standard_normal((1, t, 2, 4), dtype=np.float32)
    A = -np.ones(2, np.float32)
    dts = np.full((1, t, 2), dt, np.float32)

    def jloss(x, dts):
        y, _ = jmamba.ssd_chunked(x, dts, jnp.asarray(A), jnp.asarray(B),
                                  jnp.asarray(C), q)
        return jnp.sum(y * jnp.asarray(cot)), y

    (_, jy), (jgx, jgdt) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(x),
                                              jnp.asarray(dts))
    tx, tdt = _t(x).requires_grad_(), _t(dts).requires_grad_()
    ty, _ = tmamba.ssd_chunked(tx, tdt, _t(A), _t(B), _t(C), q)
    gx, gdt = torch.autograd.grad((ty * _t(cot)).sum(), [tx, tdt])
    assert bool(np.isfinite(np.asarray(jgdt)).all()) == (dt < 1.0)
    assert bool(torch.isfinite(gx).all()) and bool(torch.isfinite(gdt).all())
    assert err(ty.detach(), jy) <= LAYER_TOL
    assert err(gx, jgx) <= LAYER_TOL
    if dt < 1.0:
        assert err(gdt, jgdt) <= LAYER_TOL


# ---------------------------------------------------------------------------
# the Mamba layer
# ---------------------------------------------------------------------------

D_LAYER = 32
JSSM = jmamba.SSMConfig(d_state=8, d_conv=4, expand=2, headdim=8, chunk=4)
SSM = SSMConfig(d_state=8, d_conv=4, expand=2, headdim=8, chunk=4)


def _layer_pair():
    """``mamba_init``'s leaves drawn with numpy, the constant ones random
    too, and the port's layer holding them."""
    rng = np.random.default_rng(6)
    d_in, h, n = SSM.d_inner(D_LAYER), SSM.nheads(D_LAYER), SSM.d_state
    conv_dim = d_in + 2 * n

    def normal(*shape, scale=0.3):
        return scale * rng.standard_normal(shape, dtype=np.float32)

    jp = {"in_proj": {"w": normal(D_LAYER, 2 * d_in + 2 * n + h)},
          "conv_w": normal(4, conv_dim), "conv_b": normal(conv_dim),
          "A_log": normal(h), "D": 1.0 + normal(h), "dt_bias": normal(h),
          "norm": {"scale": normal(d_in)},
          "out_proj": {"w": normal(d_in, D_LAYER)}}
    layer = tmamba.Mamba(D_LAYER, SSM, dtype=torch.float32, device="cpu")
    layer.load_state_dict(tree_from_jax(jp), strict=True)
    return jax.tree.map(jnp.asarray, jp), layer


@pytest.mark.parametrize("case", ["no cache", "prefill", "continue T=4",
                                  "step"])
def test_mamba_layer_matches_reference(case):
    jp, layer = _layer_pair()
    rng = np.random.default_rng(sum(map(ord, case)))
    T = {"no cache": 8, "prefill": 8, "continue T=4": 4, "step": 1}[case]
    x = rng.standard_normal((2, T, D_LAYER), dtype=np.float32)
    cache = None
    if case != "no cache":
        cache = {k: np.zeros_like(v) for k, v in jmamba.mamba_cache_init(
            2, D_LAYER, JSSM, jnp.float32).items()}
        if case != "prefill":
            cache = {k: rng.standard_normal(v.shape, dtype=np.float32)
                     for k, v in cache.items()}
    jy, jc = jax.jit(jmamba.mamba_apply, static_argnums=2)(
        jp, jnp.asarray(x), JSSM,
        cache=None if cache is None else jax.tree.map(jnp.asarray, cache))
    tc = None if cache is None else {k: _t(v) for k, v in cache.items()}
    with torch.inference_mode():
        ty = layer(_t(x), cache=tc)
    assert ty.shape == (2, T, D_LAYER)
    assert err(ty, jy) <= LAYER_TOL
    if cache is not None:
        assert tc["ssm"].dtype == torch.float32
        for k in ("conv", "ssm"):
            assert err(tc[k], jc[k]) <= LAYER_TOL, k


def test_init_follows_the_reference_scheme():
    cfg = get_config("mamba2-2.7b").reduced()
    m = TM.init(cfg, seed=0, device="cpu").stack.blocks[0][0].mamba
    h = cfg.ssm.nheads(cfg.d_model)
    assert torch.equal(m.D, torch.ones(h))
    for t in (m.A_log, m.dt_bias, m.conv_b, m.norm.scale):
        assert not bool(t.any())
    assert 0.08 < float(m.conv_w.std()) < 0.12
    assert 0.015 < float(m.in_proj.w.std()) < 0.025


# ---------------------------------------------------------------------------
# configs and the reduced models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, reduced):
    want, got = jget_config(arch), get_config(arch)
    if reduced:
        want, got = want.reduced(), got.reduced()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.num_layers == want.num_layers
    assert got.source == want.source
    assert get_config(arch.replace("-", "_")) is get_config(arch)
    assert arch in ARCH_NAMES


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_verify_and_append_free_match_reference(arch):
    """Prefill 7 tokens, three one-token steps, then a 3-row window at a
    (B,) index: the Mamba layers continue their chunked scan from the
    cached state and ignore the index, the attention layer writes at it.
    Then an append-free step: jamba's attention layer writes nothing and
    every Mamba layer takes its step, as the reference's returns them.
    Logits at 1e-4; every Mamba state at the end at 1e-5."""
    jc, tc = cases.prefill_decode(arch)
    jcfg, cfg, jparams, tparams = cases.pair(arch)
    at = 13                                   # past both requests' rows
    tok = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 1))
    before = [{k: v.clone() for k, v in c.items()}
              for c in layer_caches(tc)]
    jl, jc = jax.jit(lambda p, c, t: JM.decode_step(
        jcfg, p, c, t, at, decode_mode="append_free",
        kernel_config=cases.REF))(jparams, jc, jnp.asarray(tok))
    with torch.inference_mode():
        tl, tc = TM.decode_step(cfg, tparams, tc, torch.from_numpy(tok), at,
                                decode_mode="append_free")
    assert err(tl, jl) <= MODEL_TOL
    after = list(layer_caches(tc))
    assert len(after) == sum(s.kind == "attn" for s in cfg.pattern) \
        * cfg.num_blocks
    assert all(torch.equal(a[k], b[k]) for a, b in zip(after, before)
               for k in a)
    for pos, spec in enumerate(cfg.pattern):
        for b, block in enumerate(tc["blocks"] if spec.kind == "mamba"
                                  else ()):
            for k in ("conv", "ssm"):
                assert err(block[pos]["mamba"][k],
                           jc["blocks"][pos]["mamba"][k][b]) <= LAYER_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    grads = cases.loss_and_grads(arch, seq=16)
    assert any(".mamba.A_log" in k for k in grads)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())


def test_convert_round_trip_of_the_mamba_leaves():
    """jamba's Mamba, attention and MoE leaves split along the blocks and
    stack back to the reference's tree bit for bit."""
    jcfg, cfg, jparams, tparams = cases.pair("jamba-1.5-large-398b")
    state = tparams.state_dict()
    flat = tree_from_jax(jax.tree.map(np.asarray, jparams))
    assert set(state) == set(flat)
    assert all(torch.equal(state[k], v) for k, v in flat.items())
    s = cfg.ssm
    d_in, h = s.d_inner(cfg.d_model), s.nheads(cfg.d_model)
    m = "stack.blocks.0.0.mamba."
    assert state[m + "in_proj.w"].shape == (cfg.d_model,
                                            2 * d_in + 2 * s.d_state + h)
    assert state[m + "conv_w"].shape == (s.d_conv, d_in + 2 * s.d_state)
    assert all(state[m + k].shape == (h,) for k in ("A_log", "D", "dt_bias"))
    assert state[m + "norm.scale"].shape == (d_in,)
    assert not any(k.startswith("stack.blocks.0.4.mamba") for k in state)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        name = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        pos, rest = name[len("stack.blocks."):].split(".", 1) \
            if name.startswith("stack.blocks.") else (None, None)
        back = state[name].numpy() if pos is None else np.stack(
            [state[f"stack.blocks.{b}.{pos}.{rest}"].numpy()
             for b in range(cfg.num_blocks)])
        assert np.array_equal(back, np.asarray(leaf)), name


def test_simulation_step_matches_reference():
    cases.sim_step("mamba2-2.7b", T=16)


def test_prompt_not_a_multiple_of_the_chunk_raises():
    cfg = get_config("mamba2-2.7b").reduced()       # chunk 8
    params = TM.init(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="multiple of the SSD chunk 8"):
        TM.prefill(cfg, params, {"tokens": torch.zeros(1, 12,
                                                       dtype=torch.int64)},
                   16, torch.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_continuous_and_speculation_raise(arch):
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    with pytest.raises(NotImplementedError) as want:
        JM.init_paged_cache(jcfg, JM.PagedCacheLayout(), jnp.float32)
    with pytest.raises(NotImplementedError) as got:
        TM.init_paged_cache(cfg, PagedCacheLayout(), torch.float32, "cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="attn layers only"):
        ContinuousEngine(cfg, slots=2, layout=PagedCacheLayout(), max_new=2,
                         device="cpu")
    with pytest.raises(NotImplementedError, match="kind='mamba'"):
        make_engine(cfg, batch=2, prompt_len=8, max_new=4, speculate_k=2,
                    device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_on_the_cpu_and_refuses_continuous(arch, capsys):
    from repro_torch.launch import serve as S
    S.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
            "8", "--gen", "3", "--device", "cpu"])
    assert "steady state on cpu" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="attn layers only"):
        S.main(["--arch", arch, "--reduced", "--continuous", "--requests",
                "2", "--prompt-len", "8", "--gen", "2", "--device", "cpu"])
