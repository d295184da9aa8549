"""The port's fixed-batch engine and sampling layer (``repro_torch.serve``)
against the JAX model and sampling layer, on the CPU.

Greedy tokens must equal, token for token, the argmax loop over the
reference's ``M.prefill`` + ``M.decode_step``.  Sampled runs use the
port's own ``torch.Generator`` streams, which cannot reproduce
``jax.random``: they are checked by their laws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.ops import KernelConfig
from repro.models import model as JM
from repro.serve import sampling as jsampling
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.serve import SamplingParams, make_engine, modified_logits

REF = KernelConfig(backend="ref")
B, PROMPT, GEN = 2, 16, 8


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("gemma3-1b").reduced()
    jcfg = jax_get_config("gemma3-1b").reduced()
    rng = np.random.default_rng(12)   # random norm scales (zero at init)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(0.3 * rng.standard_normal(
            a.shape, dtype=np.float32)) if path[-1].key == "scale" else a,
        JM.init(jcfg, jax.random.PRNGKey(1), jnp.float32))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                (B, PROMPT))
    return cfg, jcfg, jparams, tparams, prompts


def _engine(cfg, sampling=SamplingParams(), eos_id=None, batch=B):
    return make_engine(cfg, batch=batch, prompt_len=PROMPT, max_new=GEN,
                       sampling=sampling, eos_id=eos_id,
                       param_dtype=torch.float32, cache_dtype=torch.float32,
                       device="cpu")


def _run(engine, params, prompts, seed=0):
    return engine.generate_with_state(
        params, {"tokens": torch.from_numpy(prompts)}, seed=seed)


def test_greedy_tokens_equal_reference_argmax_loop(setup):
    cfg, jcfg, jparams, tparams, prompts = setup
    prefill = jax.jit(lambda p, t: JM.prefill(
        jcfg, p, {"tokens": t}, PROMPT + GEN, jnp.float32,
        kernel_config=REF))
    decode = jax.jit(lambda p, c, t, i: JM.decode_step(
        jcfg, p, c, t, i, kernel_config=REF))
    logits, caches, _ = prefill(jparams, jnp.asarray(prompts))
    tok = jnp.argmax(logits[:, -1], axis=-1)
    want = [tok]
    for i in range(1, GEN):
        logits, caches = decode(jparams, caches, tok[:, None],
                                jnp.int32(PROMPT + i - 1))
        tok = jnp.argmax(logits[:, -1], axis=-1)
        want.append(tok)
    want = np.stack([np.asarray(t) for t in want], axis=1)
    res = _run(_engine(cfg), tparams, prompts)
    assert np.array_equal(res.tokens.numpy(), want)
    assert res.lengths.tolist() == [GEN] * B
    assert not res.done.any()
    k = res.caches["blocks"][0][0]["attn"]["k"]
    assert k.shape == (B, PROMPT + GEN, cfg.num_kv_heads, cfg.head_dim)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.7, None, None), (1.0, 5, None), (1.3, None, 0.6), (0.9, 40, 0.9)])
def test_modified_logits_match_reference(temperature, top_k, top_p):
    logits = np.random.default_rng(1).standard_normal(
        (3, 257), dtype=np.float32) * 3.0
    params = dict(mode="sample", temperature=temperature, top_k=top_k,
                  top_p=top_p)
    want = np.asarray(jsampling.modified_logits(
        jnp.asarray(logits), jsampling.SamplingParams(**params)))
    got = modified_logits(torch.from_numpy(logits),
                          SamplingParams(**params)).numpy()
    assert np.array_equal(got <= -1e29, want <= -1e29)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_top_k_one_equals_greedy(setup):
    cfg, _, _, tparams, prompts = setup
    greedy = _run(_engine(cfg), tparams, prompts).tokens
    top1 = _run(_engine(cfg, SamplingParams(mode="sample", top_k=1)),
                tparams, prompts, seed=3).tokens
    assert torch.equal(greedy, top1)


def test_samples_stay_in_top_k_support():
    from repro_torch.serve.sampling import request_generators, sample_token
    logits = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 64), dtype=np.float32))
    params = SamplingParams(mode="sample", temperature=2.0, top_k=3)
    support = torch.topk(logits, 3, dim=-1).indices
    gens = request_generators(0, 4, "cpu")
    for _ in range(50):
        tok = sample_token(logits, params, gens)
        assert (support == tok[:, None]).any(dim=1).all()


def test_same_seed_same_tokens_and_slot_independence(setup):
    cfg, _, _, tparams, prompts = setup
    sp = SamplingParams(mode="sample", temperature=1.5, top_p=0.95)
    a = _run(_engine(cfg, sp), tparams, prompts, seed=7).tokens
    b = _run(_engine(cfg, sp), tparams, prompts, seed=7).tokens
    assert torch.equal(a, b)
    # slot 0 keeps its prompt; its neighbour changes, then goes away
    other = prompts.copy()
    other[1] = np.random.default_rng(9).integers(0, cfg.vocab_size, PROMPT)
    c = _run(_engine(cfg, sp), tparams, other, seed=7).tokens
    alone = _run(_engine(cfg, sp, batch=1), tparams, prompts[:1],
                 seed=7).tokens
    assert torch.equal(a[0], c[0])
    assert torch.equal(a[0], alone[0])


def test_eos_freezes_rows(setup):
    cfg, _, _, tparams, prompts = setup
    greedy = _run(_engine(cfg), tparams, prompts).tokens
    eos = int(greedy[0, 2])                 # row 0 hits eos at step 2
    res = _run(_engine(cfg, eos_id=eos), tparams, prompts)
    first = [int((row == eos).nonzero()[0]) if (row == eos).any() else None
             for row in greedy]
    for r in range(B):
        if first[r] is None:
            assert torch.equal(res.tokens[r], greedy[r])
            assert int(res.lengths[r]) == GEN and not res.done[r]
        else:
            f = first[r]
            assert torch.equal(res.tokens[r, :f + 1], greedy[r, :f + 1])
            assert (res.tokens[r, f:] == eos).all()
            assert int(res.lengths[r]) == f + 1 and res.done[r]


def test_eos_early_exit_when_every_row_is_done(setup):
    cfg, _, _, tparams, prompts = setup
    greedy = _run(_engine(cfg, batch=1), tparams, prompts[:1]).tokens
    eos = int(greedy[0, 0])
    res = _run(_engine(cfg, eos_id=eos, batch=1), tparams, prompts[:1])
    assert (res.tokens == eos).all() and res.lengths.tolist() == [1]


def test_dispatch_counter_counts_one_per_generate(setup):
    cfg, _, _, tparams, prompts = setup
    engine = _engine(cfg)
    assert engine.dispatch_counter[0] == 0
    engine.generate(tparams, {"tokens": torch.from_numpy(prompts)})
    _run(engine, tparams, prompts)
    assert engine.dispatch_counter[0] == 2
