"""The encoder-decoder in the port (seamless-m4t-large-v2: the encoder
stack, cross-attention, the stub audio frontend) against the JAX
reference, on the CPU, in f32.

- ``encode`` against the reference's at max abs 1e-5; one decoder
  layer with cross-attention against ``layer_apply(enc_out=)`` at 1e-5;
  non-causal ``ops.sdpa`` against the reference's ``ref`` oracle with the
  queries fewer than, as many as and more than the keys (a negative
  default ``q_pos0``).
- Reduced seamless-m4t-large-v2 (the reference's weights drawn with
  numpy, norm scales random): prefill over 16 stub frames, its logits,
  K/V caches and encoder output, then decode steps reading the encoder
  output from the caches in the ``"dus"`` and ``"append_free"`` modes
  (1e-4); ``loss_fn`` over 8 frames and 12 tokens (the cross-attention's
  queries outnumber its keys) and every gradient, the encoder's and the
  cross-attention's included (1e-5); ``remat=True`` gradients equal
  ``remat=False`` ones bit for bit; one DSGD-momentum step of the
  simulation engine with frames in the batch dict; the encoder and
  cross leaves split along the blocks and stack back bit for bit.
- The stub frontends' constants and shapes; the engine and the serve
  launcher with frames on the CPU; speculation and paged caches raise
  the reference's messages for the encoder-decoder.

Torch runs on one intra-op thread, and each reference function is jitted
once per module (``torch_moe_cases``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_moe_cases as cases
from repro.configs import get_config as jget_config
from repro.kernels import ref as jref
from repro.models import blocks as jblocks
from repro.models import frontends as jfrontends
from repro.models import model as JM
from repro.serve import engine as jengine
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.convert import tree_from_jax
from repro_torch.kernels import ops
from repro_torch.models import frontends
from repro_torch.models import model as TM
from repro_torch.serve import PagedCacheLayout, make_engine
from torch_moe_cases import LAYER_TOL, MODEL_TOL, REF, err

ARCH = "seamless-m4t-large-v2"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(cfg, B=2, F=16, seed=4):
    return cases.stubs(cfg, B, F, seed)["frames"]


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    want, got = jget_config(ARCH), get_config(ARCH)
    if reduced:
        want, got = want.reduced(), got.reduced()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.source == want.source and ARCH in ARCH_NAMES
    assert get_config(ARCH.replace("-", "_")) is get_config(ARCH)


def test_stub_frontends_match_the_reference_shapes():
    assert frontends.AUDIO_FRAMES == jfrontends.AUDIO_FRAMES == 1024
    assert frontends.VISION_PATCHES == jfrontends.VISION_PATCHES == 2880
    for fn in ("audio_frames_shape", "vision_patches_shape"):
        assert getattr(frontends, fn)(3, 64) == getattr(jfrontends, fn)(3,
                                                                      64)
        assert getattr(frontends, fn)(3, 64, 5) == (3, 5, 64)
    gen = torch.Generator().manual_seed(0)
    a = frontends.stub_audio_frontend(gen, 2, 64, device="cpu")
    v = frontends.stub_vision_frontend(gen, 2, 64, torch.float32,
                                       device="cpu", patches=7)
    want = jfrontends.stub_audio_frontend(jax.random.PRNGKey(0), 2, 64)
    assert a.shape == want.shape and a.dtype == torch.bfloat16
    assert v.shape == (2, 7, 64) and v.dtype == torch.float32
    assert 0.015 < float(v.std()) < 0.025
    cfg = get_config(ARCH).reduced()
    got = frontends.stub_inputs(cfg, gen, 2, 16, torch.float32, "cpu")
    assert set(got) == {"frames"} and got["frames"].shape == (2, 16, 256)
    assert frontends.stub_inputs(get_config("gemma3-1b"), gen, 2, 16,
                                 torch.float32, "cpu") == {}


def test_encode_matches_reference():
    jcfg, cfg, jparams, tparams = cases.pair(ARCH)
    frames = _frames(cfg)
    want = jax.jit(lambda p, f: JM.encode(jcfg, p, f, kernel_config=REF))(
        jparams, jnp.asarray(frames))
    with torch.inference_mode():
        got = TM.encode(cfg, tparams, torch.from_numpy(frames))
    assert got.shape == (2, 16, cfg.d_model)
    assert err(got, want) <= LAYER_TOL


def test_cross_attention_layer_matches_reference():
    """Decoder block 1's layer (self-attention, cross-attention over a
    random encoder output, the MLP) on 5 positions against 12 source
    rows."""
    jcfg, cfg, jparams, tparams = cases.pair(ARCH)
    spec = cfg.pattern[0]
    assert spec.cross_attn
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 5, cfg.d_model), dtype=np.float32)
    enc = rng.standard_normal((2, 12, cfg.d_model), dtype=np.float32)
    jp = jax.tree.map(lambda a: a[1], jparams["stack"]["blocks"][0])
    assert {"ln_x", "cross"} <= set(jp)
    want, _, _ = jax.jit(lambda p, x, e: jblocks.layer_apply(
        p, x, jcfg, jcfg.pattern[0], enc_out=e, kernel_config=REF))(
        jp, jnp.asarray(x), jnp.asarray(enc))
    layer = tparams.stack.blocks[1][0]
    with torch.inference_mode():
        got, aux = layer(torch.from_numpy(x), enc_out=torch.from_numpy(enc))
    assert aux is None and err(got, want) <= LAYER_TOL
    with pytest.raises(ValueError, match="enc_out"):
        layer(torch.from_numpy(x))


@pytest.mark.parametrize("Tq,S", [(3, 11), (11, 11), (11, 4)])
def test_non_causal_sdpa_matches_the_reference_oracle(Tq, S):
    """The plain version behind ``ops.sdpa`` on the CPU with
    ``causal=False`` and the default query start ``S - Tq`` (negative
    when the queries outnumber the keys), 7 query heads per kv head."""
    rng = np.random.default_rng(Tq * 100 + S)
    q = rng.standard_normal((2, Tq, 7, 16), dtype=np.float32)
    k, v = (rng.standard_normal((2, S, 1, 16), dtype=np.float32)
            for _ in range(2))
    want = jref.grouped_sdpa_ref(*map(jnp.asarray, (q, k, v)), causal=False)
    got = ops.sdpa(*map(torch.from_numpy, (q, k, v)), causal=False)
    assert got.shape == (2, Tq, 7, 16)
    assert err(got, want) <= LAYER_TOL


@pytest.mark.parametrize("decode_mode", ["dus", "append_free"])
def test_prefill_and_decode_match_reference(decode_mode):
    tc = cases.prefill_decode_stub(ARCH, 16, decode_mode)
    assert tc["enc_out"].shape[1] == 16


def test_loss_and_gradients_match_reference():
    grads = cases.loss_and_grads(ARCH, seq=12, stub_len=8)
    assert any(k.startswith("encoder.stack.blocks.1.") for k in grads)
    assert any(".cross.wk.w" in k for k in grads)
    assert float(grads["encoder.final_norm.scale"].abs().max()) > 0


def test_remat_gradients_equal_plain_bitwise():
    """``remat=True`` recomputes each decoder block, its cross-attention
    included, from the kept input and encoder output: the same bits."""
    _, cfg, _, tparams = cases.pair(ARCH)
    batch = {"tokens": torch.arange(20).reshape(2, 10) % cfg.vocab_size,
             "frames": torch.from_numpy(_frames(cfg, F=6))}
    batch["labels"] = batch["tokens"]
    out = []
    for remat in (False, True):
        params = {k: v.detach().clone().requires_grad_()
                  for k, v in tparams.state_dict().items()}
        loss, _ = TM.loss_fn(cfg, params, batch, remat=remat)
        out.append(torch.autograd.grad(loss, list(params.values())))
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_simulation_step_matches_reference():
    cases.sim_step(ARCH, T=12, stub_len=8)


def test_convert_round_trip_of_the_encoder_and_cross_leaves():
    jcfg, cfg, jparams, tparams = cases.pair(ARCH)
    state = tparams.state_dict()
    flat = tree_from_jax(jax.tree.map(np.asarray, jparams))
    assert set(state) == set(flat)
    assert all(torch.equal(state[k], v) for k, v in flat.items())
    d, hd = cfg.d_model, cfg.num_heads * cfg.head_dim
    assert state["stack.blocks.1.0.cross.wq.w"].shape == (d, hd)
    assert state["stack.blocks.0.0.ln_x.scale"].shape == (d,)
    assert state["encoder.stack.blocks.1.0.mlp.gate.w"].shape == (
        d, cfg.encoder.d_ff)
    assert not any(k.startswith("encoder.stack.prologue") for k in state)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        name = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        head, sep, rest = name.partition("stack.blocks.")
        if not sep:
            back = state[name].numpy()
        else:
            pos, rest = rest.split(".", 1)
            nb = leaf.shape[0]
            back = np.stack([state[f"{head}stack.blocks.{b}.{pos}.{rest}"]
                             .numpy() for b in range(nb)])
        assert np.array_equal(back, np.asarray(leaf)), name


def test_engine_generates_over_frames_on_the_cpu():
    """The fixed-batch engine over stub frames: its greedy tokens are the
    prefill / decode-step chain's, and every step reads the encoder
    output the prefill kept."""
    _, cfg, _, tparams = cases.pair(ARCH)
    P, N = 6, 4
    batch = {"tokens": torch.arange(12).reshape(2, P) * 7 % cfg.vocab_size,
             "frames": torch.from_numpy(_frames(cfg, F=10))}
    eng = make_engine(cfg, batch=2, prompt_len=P, max_new=N,
                      param_dtype=torch.float32, cache_dtype=torch.float32,
                      device="cpu")
    res = eng.generate_with_state(tparams, batch)
    with torch.inference_mode():
        lg, caches = TM.prefill(cfg, tparams, batch, eng.seq, torch.float32)
        tok, want = lg[:, -1].argmax(-1), []
        for i in range(N):
            want.append(tok)
            lg, caches = TM.decode_step(cfg, tparams, caches, tok[:, None],
                                        P + i)
            tok = lg[:, -1].argmax(-1)
    assert eng.index0 == P and eng.seq == P + N
    assert torch.equal(res.tokens, torch.stack(want, 1))
    assert torch.equal(res.caches["enc_out"], caches["enc_out"])


def test_speculation_and_paged_caches_raise_as_the_reference():
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    with pytest.raises(NotImplementedError) as want:
        jengine._check_spec_family(jcfg, "target")
    with pytest.raises(NotImplementedError) as got:
        make_engine(cfg, batch=2, prompt_len=8, max_new=4, speculate_k=2,
                    device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError) as want:
        JM.init_paged_cache(jcfg, JM.PagedCacheLayout(), jnp.float32)
    with pytest.raises(NotImplementedError) as got:
        TM.init_paged_cache(cfg, PagedCacheLayout(), torch.float32, "cpu")
    assert str(got.value) == str(want.value)


def test_serve_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve as S
    S.main(["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
            "8", "--gen", "3", "--device", "cpu"])
    assert "steady state on cpu" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        S.main(["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
                "8", "--gen", "3", "--speculate-k", "2", "--device", "cpu"])
