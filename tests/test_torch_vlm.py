"""The vision-prefix model in the port (llava-next-34b: stub patch
embeddings in front of the tokens, an untied head, 7 query heads per kv
head at full width) against the JAX reference, on the CPU, in f32.

- Configs equal the reference's field by field, full and reduced.
- Reduced llava-next-34b (the reference's weights drawn with numpy, norm
  scales random): prefill of 7 tokens after 16 prefix embeddings, its
  logits and K/V caches, then decode steps at ``prefix + prompt + i``
  (1e-4); ``loss_fn`` with ``prefix_embeds``, whose positions get
  ``-100`` labels, and every gradient (1e-5); one DSGD-momentum step of
  the simulation engine with prefix embeddings in the batch dict.
- The engine with ``prefix_len`` on the CPU: greedy tokens equal the
  prefill / decode-step chain's, and self-speculative greedy tokens
  equal plain ones; a separate draft model with a prefix raises the
  reference's message; the serve launcher runs with its 16-patch stub.

Torch runs on one intra-op thread, and each reference function is jitted
once per module (``torch_moe_cases``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

import torch_moe_cases as cases
from repro.configs import get_config as jget_config
from repro.serve import make_engine as jmake_engine
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.models import model as TM
from repro_torch.models.layers import chunked_ce_loss
from repro_torch.serve import make_engine

ARCH = "llava-next-34b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    want, got = jget_config(ARCH), get_config(ARCH)
    if reduced:
        want, got = want.reduced(), got.reduced()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.source == want.source and ARCH in ARCH_NAMES
    assert got.num_heads // got.num_kv_heads == (2 if reduced else 7)


@pytest.mark.parametrize("decode_mode", ["dus", "append_free"])
def test_prefill_with_prefix_and_decode_match_reference(decode_mode):
    tc = cases.prefill_decode_stub(ARCH, 16, decode_mode)
    assert "enc_out" not in tc


def test_loss_and_gradients_with_prefix_match_reference():
    grads = cases.loss_and_grads(ARCH, seq=12, stub_len=16)
    assert float(grads["lm_head.w"].abs().max()) > 0


def test_prefix_positions_take_no_loss():
    """The loss is the cross-entropy of the token positions alone: the
    hidden states over the prefix meet ``-100`` labels."""
    _, cfg, _, tparams = cases.pair(ARCH)
    params = dict(tparams.state_dict())
    batch = _engine_inputs(cfg, P=6, npfx=4)
    batch["labels"] = batch["tokens"].roll(-1, dims=1)
    with torch.inference_mode():
        loss, _ = TM.loss_fn(cfg, params, batch)
        h, _, _ = tparams(batch["tokens"],
                          prefix_embeds=batch["prefix_embeds"])
        want = chunked_ce_loss(h[:, 4:], params["lm_head.w"],
                               batch["labels"])
    assert h.shape[1] == 10 and abs(float(loss) - float(want)) <= 1e-6


def test_simulation_step_matches_reference():
    cases.sim_step(ARCH, T=12, stub_len=4)


def _engine_inputs(cfg, P=6, npfx=5):
    return {"tokens": torch.arange(2 * P).reshape(2, P) * 5 % cfg.vocab_size,
            "prefix_embeds": torch.from_numpy(
                cases.stubs(cfg, 2, npfx, 3)["prefix_embeds"])}


def test_engine_generates_after_a_prefix_on_the_cpu():
    _, cfg, _, tparams = cases.pair(ARCH)
    P, N, npfx = 6, 5, 5
    batch = _engine_inputs(cfg, P, npfx)
    eng = make_engine(cfg, batch=2, prompt_len=P, max_new=N,
                      prefix_len=npfx, param_dtype=torch.float32,
                      cache_dtype=torch.float32, device="cpu")
    assert eng.index0 == P + npfx and eng.seq == P + npfx + N
    res = eng.generate_with_state(tparams, batch)
    with torch.inference_mode():
        lg, caches = TM.prefill(cfg, tparams, batch, eng.seq, torch.float32)
        tok, want = lg[:, -1].argmax(-1), []
        for i in range(N):
            want.append(tok)
            lg, caches = TM.decode_step(cfg, tparams, caches, tok[:, None],
                                        npfx + P + i)
            tok = lg[:, -1].argmax(-1)
    assert torch.equal(res.tokens, torch.stack(want, 1))
    with pytest.raises(ValueError, match="prefix"):
        eng.generate(tparams, {"tokens": batch["tokens"]})


def test_self_speculative_greedy_tokens_equal_plain_with_a_prefix():
    _, cfg, _, tparams = cases.pair(ARCH)
    P, N, npfx = 6, 7, 5
    batch = _engine_inputs(cfg, P, npfx)
    kw = dict(batch=2, prompt_len=P, max_new=N, prefix_len=npfx,
              param_dtype=torch.float32, cache_dtype=torch.float32,
              device="cpu")
    plain = make_engine(cfg, **kw).generate_with_state(tparams, batch)
    spec = make_engine(cfg, speculate_k=2, draft_layers=1,
                       **kw).generate_with_state(tparams, batch)
    assert torch.equal(spec.tokens, plain.tokens)
    assert int(spec.spec.rounds.max()) >= 1


def test_draft_model_with_a_prefix_raises_as_the_reference():
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with pytest.raises(NotImplementedError) as want:
        jmake_engine(jcfg, mesh, batch=2, prompt_len=8, max_new=4,
                     prefix_len=4, speculate_k=2, draft_cfg=jcfg,
                     param_dtype=jnp.float32, cache_dtype=jnp.float32)
    with pytest.raises(NotImplementedError) as got:
        make_engine(cfg, batch=2, prompt_len=8, max_new=4, prefix_len=4,
                    speculate_k=2, draft_cfg=cfg, device="cpu")
    assert str(got.value) == str(want.value)


def test_serve_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve as S
    S.main(["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
            "8", "--gen", "3", "--device", "cpu", "--speculate-k", "2"])
    out = capsys.readouterr().out
    assert "steady state on cpu" in out and "speculative: k=2" in out
