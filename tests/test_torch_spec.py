"""The port's fixed-batch speculative serving path on the CPU: the plain
version of ``ops.sdpa_decode`` (``ref.grouped_sdpa_decode_ref``), the
dense (B,)-``cache_index`` and ``"append_free"`` decode steps,
``decode_logits_scan``, and the engine's speculative rounds
(``repro_torch.serve.engine``), against the reference.

The attention inputs are numpy arrays from a seed, given to both
packages: the plain versions agree within f32 atol 1e-5, the port and
the reference's TPU kernel in interpret mode too.  The decode steps
start from the reference's weights and caches (reduced gemma3-1b, f32,
random norm scales) and agree in logits within 1e-4, the model tests'
tolerance for a stack of f32 layers.

The reference's ``make_engine(...).generate`` fails on the CPU with
jax 0.9's explicit mesh axes (ROADMAP.md, queue 3), so the engine is
held by the reference's own laws (``tests/test_serve_speculative.py``):
greedy speculative tokens equal the plain engine's, a full-depth draft
accepts everything, rejected drafts leave the caches as if nothing was
drafted, eos freezes rows as plain decoding does, and the validation
errors are the reference's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import LayerSpec as JLayerSpec
from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ops import KernelConfig
from repro.models import model as JM
from repro.serve import decode_logits_scan as jdecode_scan
from repro.serve import make_engine as jmake_engine
from repro_torch.configs import LayerSpec, get_config
from repro_torch.convert import (paged_cache_from_jax, paged_cache_to_numpy,
                                 params_from_jax)
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.models.blocks import layer_caches
from repro_torch.serve import (SamplingParams, SpecStats, decode_logits_scan,
                               make_engine)

REF = KernelConfig(backend="ref")
PALLAS = KernelConfig(backend="pallas", interpret=True)
TOL = 1e-5
MODEL_TOL = 1e-4
B, P, N = 2, 5, 7          # engine: batch, prompt, max_new

# (H, KV): MQA (gemma3's 4 / 1) and GQA
FAMILIES = [("mqa", 4, 1), ("gqa", 8, 2)]


def _qkv(seed, Bq, Tq, S, H, KV, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Bq, Tq, H, hd), dtype=np.float32)
    k = rng.standard_normal((Bq, S, KV, hd), dtype=np.float32)
    v = rng.standard_normal((Bq, S, KV, hd), dtype=np.float32)
    return q, k, v


def _tails(a, valid, fill):
    """A torch copy of ``a`` with request b's rows at or past valid[b]
    set to ``fill``."""
    t = torch.from_numpy(a.copy())
    for b, n in enumerate(valid):
        t[b, n:] = fill
    return t


def _err(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float32)
                               - np.asarray(want, np.float32))))


# ---------------------------------------------------------------------------
# the plain version and ops.sdpa_decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fam,H,KV", FAMILIES)
@pytest.mark.parametrize("hd", [64, 256])
@pytest.mark.parametrize("Tq", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("window,softcap", [(None, None), (4, None),
                                            (None, 30.0)],
                         ids=["plain", "window", "softcap"])
def test_decode_ref_matches_reference(fam, H, KV, hd, Tq, window, softcap):
    """Ragged per-request positions (one request at position 0), a valid
    prefix per request; the reference sees zeros past it, the port NaN."""
    S = 16
    q, k, v = _qkv(Tq, 3, Tq, S, H, KV, hd)
    qs = np.array([0, 6, 11 - Tq], np.int32)
    kv = qs + Tq
    k0, v0 = (_tails(a, kv, 0.0).numpy() for a in (k, v))
    want = jref.grouped_sdpa_decode_ref(
        jnp.asarray(q), jnp.asarray(k0), jnp.asarray(v0),
        q_start=jnp.asarray(qs), k_valid_len=jnp.asarray(kv), window=window,
        softcap=softcap)
    got = ops.sdpa_decode(torch.from_numpy(q), _tails(k, kv, float("nan")),
                          _tails(v, kv, float("nan")),
                          q_start=torch.from_numpy(qs),
                          k_valid_len=torch.from_numpy(kv), window=window,
                          softcap=softcap)
    assert got.shape == (3, Tq, H, hd)
    assert _err(got, want) <= TOL


@pytest.mark.parametrize("fam,H,KV", FAMILIES)
@pytest.mark.parametrize("hd", [64, 256])
@pytest.mark.parametrize("Tq,q_start,k_valid", [
    (1, [7, 15], [8, 16]),       # a decode step
    (3, [0, 5], [3, 8]),         # a verify window with a fresh request
    (5, [4, 11], [9, 16]),       # k = 4, ragged positions
])
def test_sdpa_decode_matches_pallas_interpret(fam, H, KV, hd, Tq, q_start,
                                              k_valid):
    """The port against the reference's TPU kernel in interpret mode with a
    vector q_start (``tests/test_decode_attention.py:97-114``)."""
    q, k, v = _qkv(hd + Tq, 2, Tq, 16, H, KV, hd)
    qs = np.array(q_start, np.int32)
    kv = np.array(k_valid, np.int32)
    want = jops.sdpa_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            q_start=jnp.asarray(qs), k_valid_len=jnp.asarray(
                                kv), window=4, config=PALLAS)
    got = ops.sdpa_decode(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), q_start=torch.from_numpy(qs),
                          k_valid_len=torch.from_numpy(kv), window=4)
    assert _err(got, want) <= TOL


@pytest.mark.parametrize("fam,H,KV", FAMILIES)
@pytest.mark.parametrize("window,softcap", [(None, None), (4, 30.0)],
                         ids=["plain", "window+softcap"])
def test_verify_window_equals_one_row_calls_bitwise(fam, H, KV, window,
                                                    softcap):
    """One (B, k+1)-row call equals k+1 one-row calls bit for bit on the
    CPU (the law of ``tests/test_decode_attention.py:63``), each one-row
    call as a plain decode step makes it: the cache valid through its own
    row."""
    Tq = 5
    q, k, v = (torch.from_numpy(a) for a in _qkv(9, 2, Tq, 24, H, KV, 64))
    qs = torch.tensor([3, 11])
    kw = dict(window=window, softcap=softcap)
    fused = ops.sdpa_decode(q, k, v, q_start=qs, k_valid_len=qs + Tq, **kw)
    for i in range(Tq):
        one = ops.sdpa_decode(q[:, i:i + 1], k, v, q_start=qs + i,
                              k_valid_len=qs + i + 1, **kw)
        assert torch.equal(one, fused[:, i:i + 1]), i


def test_sdpa_decode_has_no_gradient():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 2, 8, 4, 1, 64))
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.sdpa_decode(q.requires_grad_(), k, v, q_start=torch.tensor([2]),
                        k_valid_len=torch.tensor([4]))
    with torch.no_grad():
        assert ops.sdpa_decode(q, k, v, q_start=torch.tensor([2]),
                               k_valid_len=torch.tensor([4])).shape \
            == (1, 2, 4, 64)


# ---------------------------------------------------------------------------
# the decode steps against the reference's M.decode_step
# ---------------------------------------------------------------------------

def _random_norm_scales(jparams, seed):
    """The reference initialises every norm scale to zero; random scales
    make a misplaced norm show in the logits (and give the speculative
    drafts something to reject)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(0.3 * rng.standard_normal(
            a.shape, dtype=np.float32)) if path[-1].key == "scale" else a,
        jparams)


@functools.lru_cache(maxsize=None)
def _setup(num_blocks=None, seed=1):
    jcfg = jget_config("gemma3-1b").reduced(num_blocks=num_blocks)
    cfg = get_config("gemma3-1b").reduced(num_blocks=num_blocks)
    jparams = _random_norm_scales(
        JM.init(jcfg, jax.random.PRNGKey(seed), jnp.float32), seed + 11)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jcfg, cfg, jparams, params


def _prefilled(jcfg, jparams, tokens, S):
    """The reference's prefill of ``tokens`` into an S-position cache, and
    the same caches carried into the port (the dense layout is the pool
    layout: leaves (B, S, KV, hd), the blocks stacked)."""
    _, jc, _ = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(tokens)}, S,
                          jnp.float32, kernel_config=REF)
    return jc, paged_cache_from_jax(jax.tree.map(np.asarray, jc),
                                    device="cpu")


def _assert_caches_close(got, want, tol):
    for a, b in zip(jax.tree.leaves(paged_cache_to_numpy(got)),
                    jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=tol)


@pytest.mark.parametrize("T", [1, 3])
def test_vector_cache_index_decode_step_matches_reference(T):
    """A (B,) cache_index over a dense cache: request 0 appends after its
    prompt, request 1 rewrites its last three positions."""
    jcfg, cfg, jparams, params = _setup()
    rng = np.random.default_rng(20 + T)
    Pp, S = 7, 12
    prompt = rng.integers(0, cfg.vocab_size, (2, Pp))
    new = rng.integers(0, cfg.vocab_size, (2, T))
    idx = np.array([Pp, Pp - 3], np.int32)
    jc, caches = _prefilled(jcfg, jparams, prompt, S)
    jl, jc = JM.decode_step(jcfg, jparams, jc, jnp.asarray(new),
                            jnp.asarray(idx), kernel_config=REF)
    with torch.inference_mode():
        tl, tc = M.decode_step(cfg, params, caches, torch.from_numpy(new),
                               torch.from_numpy(idx).long())
    assert tl.shape == (2, T, cfg.vocab_size)
    assert _err(tl, jl) <= MODEL_TOL
    assert tc is caches                 # written in place
    _assert_caches_close(tc, jc, TOL)


def test_append_free_decode_step_matches_reference_and_writes_nothing():
    jcfg, cfg, jparams, params = _setup()
    rng = np.random.default_rng(31)
    Pp, S = 7, 10
    prompt = rng.integers(0, cfg.vocab_size, (2, Pp))
    tok = rng.integers(0, cfg.vocab_size, (2, 1))
    jc, caches = _prefilled(jcfg, jparams, prompt, S)
    before = [{n: c[n].clone() for n in ("k", "v")}
              for c in layer_caches(caches)]
    jl, jc2 = JM.decode_step(jcfg, jparams, jc, jnp.asarray(tok),
                             jnp.int32(Pp), decode_mode="append_free",
                             kernel_config=REF)
    with torch.inference_mode():
        tl, tc = M.decode_step(cfg, params, caches, torch.from_numpy(tok),
                               Pp, decode_mode="append_free")
        dl, _ = M.decode_step(cfg, params, caches, torch.from_numpy(tok),
                              Pp)
    assert _err(tl, jl) <= MODEL_TOL
    assert tc is caches
    for got, want in zip(layer_caches(caches), before):
        # the "dus" step above wrote position Pp only
        assert all(torch.equal(got[n][:, :Pp], want[n][:, :Pp])
                   and torch.equal(got[n][:, Pp + 1:], want[n][:, Pp + 1:])
                   for n in ("k", "v"))
    for a, b in zip(jax.tree.leaves(jc2), jax.tree.leaves(jc)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    # the two modes compute one function in two orders
    assert _err(tl, dl) <= MODEL_TOL


def test_append_free_leaves_every_cache_bit_unchanged():
    """Three append-free steps after a prefill: every bit of every cache
    stays as the prefill left it."""
    _, cfg, _, params = _setup()
    tokens = torch.tensor([[3, 1, 4, 1, 5, 9], [2, 6, 5, 3, 5, 8]])
    with torch.inference_mode():
        _, caches = M.prefill(cfg, params, {"tokens": tokens}, 9,
                              torch.float32)
        bits = [c[n].view(torch.int32).clone() for c in layer_caches(caches)
                for n in ("k", "v")]
        for i in range(6, 9):
            _, out = M.decode_step(cfg, params, caches, tokens[:, i - 6:i - 5],
                                   i, decode_mode="append_free")
            assert out is caches
    now = [c[n].view(torch.int32) for c in layer_caches(caches)
           for n in ("k", "v")]
    assert all(torch.equal(a, b) for a, b in zip(now, bits))


@pytest.mark.parametrize("vector", [False, True], ids=["int", "vector"])
def test_decode_logits_scan_matches_reference(vector):
    """Teacher-forced scoring from the same caches: per-step logits within
    1e-4 of the reference's, the caches within 1e-5."""
    jcfg, cfg, jparams, params = _setup()
    rng = np.random.default_rng(40)
    Pp, T, S = 6, 5, 12
    prompt = rng.integers(0, cfg.vocab_size, (2, Pp))
    toks = rng.integers(0, cfg.vocab_size, (2, T))
    jc, caches = _prefilled(jcfg, jparams, prompt, S)
    i0 = np.array([Pp, Pp - 2], np.int32) if vector else Pp
    jl, jc = jdecode_scan(jcfg, jparams, jc, jnp.asarray(toks),
                          jnp.asarray(i0), kernel_config=REF)
    tl, tc = decode_logits_scan(
        cfg, params, caches, torch.from_numpy(toks),
        torch.from_numpy(i0).long() if vector else i0)
    assert tl.shape == (2, T, cfg.vocab_size)
    assert _err(tl, jl) <= MODEL_TOL
    _assert_caches_close(tc, jc, TOL)


# ---------------------------------------------------------------------------
# the engine: the reference's laws
# ---------------------------------------------------------------------------

def _engine_setup():
    """Reduced gemma3-1b with 2 pattern blocks (so a 1-block draft is
    partial) and a seeded prompt batch."""
    _, cfg, _, params = _setup(num_blocks=2)
    tokens = torch.from_numpy(np.random.default_rng(50).integers(
        0, cfg.vocab_size, (B, P)))
    return cfg, params, {"tokens": tokens}


def _engine(cfg, **kw):
    return make_engine(cfg, batch=B, prompt_len=P, max_new=N,
                       param_dtype=torch.float32, cache_dtype=torch.float32,
                       device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _plain():
    cfg, params, batch = _engine_setup()
    return _engine(cfg).generate_with_state(params, batch)


def _draft_params(cfg, seed):
    _, dcfg, _, dparams = _setup(num_blocks=cfg.num_blocks - 1, seed=seed)
    return dcfg, dparams


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("draft", ["self", "draft_cfg"])
def test_greedy_spec_tokens_equal_plain_tokens(k, draft):
    cfg, params, batch = _engine_setup()
    if draft == "self":
        eng = _engine(cfg, speculate_k=k, draft_layers=1)
        res = eng.generate_with_state(params, batch)
    else:
        dcfg, dparams = _draft_params(cfg, 7)
        eng = _engine(cfg, speculate_k=k, draft_cfg=dcfg)
        res = eng.generate_with_state(params, batch, draft_params=dparams)
    assert eng.dispatch_counter[0] == 1
    assert eng.seq == P + N + k
    assert torch.equal(res.tokens, _plain().tokens)
    assert torch.equal(res.lengths, _plain().lengths)
    rounds = res.spec.rounds
    # every live round emits 1 to k + 1 tokens
    assert bool((rounds >= -(-(N - 1) // (k + 1))).all())
    assert bool((rounds <= N - 1).all())
    assert torch.equal(res.spec.drafted, rounds * k)
    assert bool((res.spec.accepted <= res.spec.drafted).all())


def test_drafts_are_rejected_and_accepted():
    """The laws above are not vacuous: the 1-block draft is rejected in
    some rounds and accepted in others."""
    cfg, params, batch = _engine_setup()
    res = _engine(cfg, speculate_k=4, draft_layers=1).generate_with_state(
        params, batch)
    acc, drafted = int(res.spec.accepted.sum()), int(res.spec.drafted.sum())
    assert 0 < acc < drafted


def test_full_depth_draft_accepts_everything():
    cfg, params, batch = _engine_setup()
    res = _engine(cfg, speculate_k=2, draft_layers=cfg.num_blocks) \
        .generate_with_state(params, batch)
    assert torch.equal(res.tokens, _plain().tokens)
    assert torch.equal(res.spec.accepted, res.spec.drafted)
    assert bool((res.spec.drafted > 0).all())


def test_draft_config_spec_is_lossless():
    """A separate draft, random or the target itself, never changes the
    greedy tokens; the target as its own draft accepts everything; the
    engine needs draft_params."""
    cfg, params, batch = _engine_setup()
    eng = _engine(cfg, speculate_k=2, draft_cfg=cfg)
    _, bad = _setup(num_blocks=cfg.num_blocks, seed=123)[2:]
    res = eng.generate_with_state(params, batch, draft_params=bad)
    assert torch.equal(res.tokens, _plain().tokens)
    res2 = eng.generate_with_state(params, batch, draft_params=params)
    assert torch.equal(res2.tokens, _plain().tokens)
    assert torch.equal(res2.spec.accepted, res2.spec.drafted)
    with pytest.raises(ValueError, match="draft_params"):
        eng.generate_with_state(params, batch)


def _frontier_check(spec_caches, plain_caches, lim):
    """Spec caches equal the plain caches bit for bit on [0, lim) and hold
    their initial zeros past it."""
    for a, b in zip(layer_caches(spec_caches), layer_caches(plain_caches)):
        for n in ("k", "v"):
            assert torch.equal(a[n][:, :lim], b[n][:, :lim])
            assert not bool(a[n][:, lim:].any()), \
                "rejected draft rows survived past the frontier"


def test_rejected_drafts_leave_dense_cache_clean():
    """The final caches equal the plain engine's bit for bit up to the
    last written position, and every row past it still holds zeros."""
    cfg, params, batch = _engine_setup()
    res = _engine(cfg, speculate_k=2, draft_layers=1).generate_with_state(
        params, batch)
    assert int(res.spec.accepted.sum()) < int(res.spec.drafted.sum())
    # the last emitted token's K/V is written by neither engine
    _frontier_check(res.caches, _plain().caches, P + N - 1)


def test_rejected_drafts_leave_draft_cache_clean():
    """With a draft_cfg the draft's own cache is restored too: after the
    rounds it equals the draft model's plain teacher-forced decode of the
    emitted tokens bit for bit, and holds zeros past it."""
    cfg, params, batch = _engine_setup()
    dcfg, dparams = _draft_params(cfg, 7)
    eng = _engine(cfg, speculate_k=2, draft_cfg=dcfg)
    with torch.inference_mode():
        logits, caches = M.prefill(cfg, params, batch, eng.seq,
                                   torch.float32)
        _, dcaches = M.prefill(dcfg, dparams, batch, eng.seq, torch.float32)
        toks, _, spec = eng._speculate(params, logits, caches, 0, dparams,
                                       dcaches)
        _, plain = M.prefill(dcfg, dparams, batch, eng.seq, torch.float32)
    assert int(spec.accepted.sum()) < int(spec.drafted.sum())
    assert torch.equal(toks, _plain().tokens)
    decode_logits_scan(dcfg, dparams, plain, toks[:, :N - 1], P)
    _frontier_check(dcaches, plain, P + N - 1)


def test_spec_eos_freezes_like_plain():
    cfg, params, batch = _engine_setup()
    eos = int(_plain().tokens[0, 1])          # row 0 emits it early
    kw = dict(eos_id=eos)
    plain = _engine(cfg, **kw).generate_with_state(params, batch)
    spec = _engine(cfg, speculate_k=2, draft_layers=1,
                   **kw).generate_with_state(params, batch)
    assert bool(plain.done[0]) and int(plain.lengths[0]) == 2
    for f in ("tokens", "done", "lengths"):
        assert torch.equal(getattr(spec, f), getattr(plain, f)), f


def test_sampled_full_depth_draft_accepts_all_and_is_deterministic():
    """With the draft == the target, q == p bit for bit, so the residual
    rule accepts every draft; the draws follow the seed."""
    cfg, params, batch = _engine_setup()
    samp = SamplingParams(mode="sample", temperature=0.8, top_k=16)
    eng = _engine(cfg, sampling=samp, speculate_k=2,
                  draft_layers=cfg.num_blocks)
    a = eng.generate_with_state(params, batch, seed=3)
    b = eng.generate_with_state(params, batch, seed=3)
    c = eng.generate_with_state(params, batch, seed=4)
    assert torch.equal(a.spec.accepted, a.spec.drafted)
    assert torch.equal(a.tokens, b.tokens)
    assert not torch.equal(a.tokens, c.tokens)
    assert bool(((a.tokens >= 0) & (a.tokens < cfg.vocab_size)).all())


def test_plain_engine_has_no_spec_stats():
    assert _plain().spec is None
    assert SpecStats._fields == ("rounds", "drafted", "accepted")


def _ssm(cfg, spec_cls):
    return dataclasses.replace(cfg, prologue=(),
                               pattern=(spec_cls(kind="mamba"),))


@pytest.mark.parametrize("case", ["negative_k", "both", "draft_layers",
                                  "ssm", "vocab"])
def test_spec_engine_validation_matches_reference(case):
    """The port raises the reference's error, type and message, for each
    of ``tests/test_serve_speculative.py:341-360``'s cases."""
    jcfg, cfg, _, _ = _setup()
    args = {
        "negative_k": lambda c, s: (c, dict(speculate_k=-1)),
        "both": lambda c, s: (c, dict(speculate_k=2, draft_layers=1,
                                      draft_cfg=c)),
        "draft_layers": lambda c, s: (c, dict(
            speculate_k=2, draft_layers=c.num_blocks + 1)),
        "ssm": lambda c, s: (_ssm(c, s), dict(speculate_k=2)),
        "vocab": lambda c, s: (c, dict(speculate_k=2, draft_cfg=(
            dataclasses.replace(c, vocab_size=c.vocab_size // 2)))),
    }[case]
    kw = dict(batch=B, prompt_len=P, max_new=N)
    jc, jkw = args(jcfg, JLayerSpec)
    with pytest.raises((ValueError, NotImplementedError)) as want:
        jmake_engine(jc, jax.make_mesh((1, 1), ("data", "model")),
                     param_dtype=jnp.float32, cache_dtype=jnp.float32,
                     **jkw, **kw)
    c, tkw = args(cfg, LayerSpec)
    with pytest.raises(want.type) as got:
        make_engine(c, device="cpu", **tkw, **kw)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft", [["--draft-layers", "0"],
                                   ["--draft-config", "gemma3-1b"]],
                         ids=["self", "draft_config"])
def test_fixed_batch_speculative_launcher_runs_on_the_cpu(capsys, draft):
    from repro_torch.launch import serve
    serve.main(["--arch", "gemma3-1b", "--reduced", "--batch", "2",
                "--prompt-len", "8", "--gen", "5", "--speculate-k", "2",
                "--device", "cpu", *draft])
    out = capsys.readouterr().out
    assert "steady state on cpu" in out and "for 10 tokens" in out
    assert "speculative: k=2," in out and "tokens per sequential pass" in out


def test_draft_config_is_fixed_batch_only():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="fixed-batch only"):
        serve.main(["--arch", "gemma3-1b", "--reduced", "--continuous",
                    "--speculate-k", "2", "--draft-config", "gemma3-1b",
                    "--device", "cpu"])
