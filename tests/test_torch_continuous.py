"""The port's continuous-batching engine over a paged KV cache
(``repro_torch.serve.continuous``, ``serve.paged``, the ``"paged"`` decode
mode) against the reference's ``ContinuousEngine.run``, on the CPU.

Both sides start from the reference's weights (reduced gemma3-1b, f32,
random norm scales).  Greedy runs must give each request the reference's
tokens, token for token, and the reference's ``stats`` dict (steps,
waits, utilization, dispatches, executables, speculative counters):
plainly, with ``speculate_k=2``, and with ``prefill_batch=2``.  The
paged-decode logits equal the port's dense-decode logits bit for bit (a
gather is indexing) and the reference's within 1e-4, the model tests'
tolerance for a stack of f32 layers.  Sampled runs use the port's own
generators, which cannot reproduce ``jax.random``: they are checked by
their laws.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels.ops import KernelConfig
from repro.models import attention as jattention
from repro.models import model as JM
from repro.serve import ContinuousEngine as JEngine
from repro.serve import Request as JRequest
from repro.serve import decode_logits_scan as jdecode_scan
from repro.serve import paged as jpaged
from repro.serve import sampling as jsampling
from repro_torch.configs import get_config
from repro_torch.convert import (paged_cache_from_jax, paged_cache_to_numpy,
                                 params_from_jax)
from repro_torch.models import model as M
from repro_torch.serve import (ContinuousEngine, PagedCacheLayout, PagePool,
                               Request, SamplingParams, bucket_for,
                               decode_logits_scan, poisson_trace,
                               prompt_buckets, speculative_accept)

REF = KernelConfig(backend="ref")
LAYOUT = dict(page_size=4, num_pages=19, max_pages_per_slot=6)
KW = dict(slots=3, max_new=5, buckets=(4, 8, 16))


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = jget_config("gemma3-1b").reduced()
    cfg = get_config("gemma3-1b").reduced()
    rng = np.random.default_rng(12)   # random norm scales (zero at init)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(0.3 * rng.standard_normal(
            a.shape, dtype=np.float32)) if path[-1].key == "scale" else a,
        JM.init(jcfg, jax.random.PRNGKey(1), jnp.float32))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jcfg, cfg, jparams, params


def _trace(cfg, n=8, seed=3):
    return poisson_trace(n, rate=0.7, seed=seed, min_prompt=2, max_prompt=14,
                         vocab_size=cfg.vocab_size)


def _jtrace(reqs):
    return [JRequest(rid=r.rid, tokens=r.tokens, arrival=r.arrival)
            for r in reqs]


def _engines(jcfg, cfg, **kw):
    kw = {**KW, **kw}
    jeng = JEngine(jcfg, layout=JM.PagedCacheLayout(**LAYOUT),
                   kernel_config=REF, cache_dtype=jnp.float32, **kw)
    eng = ContinuousEngine(cfg, layout=PagedCacheLayout(**LAYOUT),
                           param_dtype=torch.float32,
                           cache_dtype=torch.float32, device="cpu", **kw)
    return jeng, eng


# ---------------------------------------------------------------------------
# host-side bookkeeping
# ---------------------------------------------------------------------------

def test_page_pool_matches_reference():
    pools = (PagePool(8), jpaged.PagePool(8))
    for pool in pools:
        assert pool.available == 7           # page 0 reserved scratch
    a = [p.alloc(3) for p in pools]
    assert a[0] == a[1] and 0 not in a[0]
    b = [p.alloc(2) for p in pools]
    assert b[0] == b[1]
    for pool, got in zip(pools, a):
        pool.free(got)
        with pytest.raises(ValueError):
            pool.free(got)                   # double free
        with pytest.raises(RuntimeError):
            pool.alloc(6)
    assert [p.alloc(4) for p in pools][0] == a[1][:3] + [b[1][-1] + 1]
    with pytest.raises(ValueError):
        PagePool(1)


@pytest.mark.parametrize("max_prompt,min_bucket", [(48, 8), (1024, 16),
                                                   (16, 4), (5, 8)])
def test_buckets_match_reference(max_prompt, min_bucket):
    got = prompt_buckets(max_prompt, min_bucket=min_bucket)
    assert got == jpaged.prompt_buckets(max_prompt, min_bucket=min_bucket)
    for n in {1, min_bucket, min_bucket + 1, max_prompt}:
        if n > got[-1]:
            continue
        assert bucket_for(n, got) == jpaged.bucket_for(n, got)
    with pytest.raises(ValueError):
        bucket_for(got[-1] + 1, got)


@pytest.mark.parametrize("args", [
    dict(num_requests=32, rate=0.5, seed=0, min_prompt=64, max_prompt=1024,
         vocab_size=262144),
    dict(num_requests=8, rate=0.7, seed=3, min_prompt=2, max_prompt=14,
         vocab_size=512),
    dict(num_requests=5, rate=2.0, seed=11)])
def test_poisson_trace_equals_reference(args):
    got = poisson_trace(**args)
    want = jpaged.poisson_trace(**args)
    assert [(r.rid, r.tokens, r.arrival) for r in got] == \
        [(r.rid, r.tokens, r.arrival) for r in want]
    with pytest.raises(ValueError):
        poisson_trace(3, rate=0.0, seed=0)


@pytest.mark.parametrize("kw", [dict(page_size=8, num_pages=4,
                                     max_pages_per_slot=4),
                                dict(page_size=0), dict(num_pages=1)])
def test_layout_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        JM.PagedCacheLayout(**kw)
    with pytest.raises(ValueError):
        PagedCacheLayout(**kw)
    lay = PagedCacheLayout(page_size=8, max_pages_per_slot=4)
    assert lay.max_seq == 32 and lay.pages_for(9) == 2


def test_paged_cache_has_the_reference_pools():
    jcfg, cfg, _, _ = _setup()
    lay = PagedCacheLayout(**LAYOUT)
    pools = M.init_paged_cache(cfg, lay, torch.float32, "cpu")
    want = JM.init_paged_cache(jcfg, JM.PagedCacheLayout(**LAYOUT),
                               jnp.float32)
    got = paged_cache_to_numpy(pools)
    assert jax.tree.map(np.shape, got) == jax.tree.map(np.shape, want)
    back = paged_cache_from_jax(want, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), back) == \
        jax.tree.map(lambda t: tuple(t.shape), pools)


# ---------------------------------------------------------------------------
# the paged decode mode
# ---------------------------------------------------------------------------

def test_decode_logits_scan_dense_vs_paged():
    """Paged scoring equals dense scoring bit for bit (the reference's
    contract, ``test_decode_logits_scan_dense_vs_paged``) and the
    reference's paged scoring within 1e-4."""
    jcfg, cfg, jparams, params = _setup()
    B, T = 2, 9
    lay = PagedCacheLayout(page_size=8, num_pages=12, max_pages_per_slot=4)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, T))
    dense = M.init_cache(cfg, B, lay.max_seq, torch.float32, "cpu")
    ld, _ = decode_logits_scan(cfg, params, dense, torch.from_numpy(tokens),
                               0)
    pools = M.init_paged_cache(cfg, lay, torch.float32, "cpu")
    table = np.stack([PagePool(12).alloc(4) for _ in range(B)])
    table[1] = [5, 6, 7, 8]
    lp, _ = decode_logits_scan(
        cfg, params, pools, torch.from_numpy(tokens),
        torch.zeros(B, dtype=torch.int64), decode_mode="paged",
        block_table=torch.from_numpy(table.astype(np.int32)))
    assert torch.equal(lp, ld)
    jpools = JM.init_paged_cache(jcfg, JM.PagedCacheLayout(
        page_size=8, num_pages=12, max_pages_per_slot=4), jnp.float32)
    jl, jpools = jdecode_scan(jcfg, jparams, jpools, jnp.asarray(tokens),
                              jnp.zeros((B,), jnp.int32),
                              decode_mode="paged",
                              block_table=jnp.asarray(table, jnp.int32),
                              kernel_config=REF)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4)
    got = paged_cache_to_numpy(pools)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jpools)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)


def test_draft_layers_run_the_first_blocks_only():
    """``draft_layers=0`` runs the prologue alone: the pattern blocks'
    pools stay untouched, and the logits are those of a model cut to
    its prologue."""
    jcfg, cfg, jparams, params = _setup()
    lay = PagedCacheLayout(page_size=4, num_pages=4, max_pages_per_slot=3)
    pools = M.init_paged_cache(cfg, lay, torch.float32, "cpu")
    table = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    tok = torch.tensor([[5, 9, 2]])
    with torch.inference_mode():
        lg, _ = M.decode_step(cfg, params, pools, tok,
                              torch.tensor([0]), decode_mode="paged",
                              block_table=table, draft_layers=0)
    assert all(not bool(c["attn"][n].any()) for blk in pools["blocks"]
               for c in blk for n in ("k", "v"))
    assert bool(pools["prologue"][0]["attn"]["k"].any())
    jpools = JM.init_paged_cache(jcfg, JM.PagedCacheLayout(
        page_size=4, num_pages=4, max_pages_per_slot=3), jnp.float32)
    jl, _ = JM.decode_step(jcfg, jparams, jpools, jnp.asarray(tok.numpy()),
                           jnp.zeros((1,), jnp.int32), decode_mode="paged",
                           block_table=jnp.asarray(table.numpy()),
                           kernel_config=REF, draft_layers=0)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="num_blocks_limit"):
        M.decode_step(cfg, params, pools, tok, torch.tensor([0]),
                      decode_mode="paged", block_table=table,
                      draft_layers=cfg.num_blocks + 1)


def test_unported_decode_modes_raise():
    """Every decode mode of the reference is ported (``"append_free"`` and
    a dense vector cache_index: tests/test_torch_spec.py); a mode the
    reference lacks raises, naming the ported ones."""
    _, cfg, _, params = _setup()
    assert M.DECODE_MODES == jattention.DECODE_MODES
    caches = M.init_cache(cfg, 1, 8, torch.float32, "cpu")
    tok = torch.zeros((1, 1), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="append_free"):
        M.decode_step(cfg, params, caches, tok, 0, decode_mode="ring")


# ---------------------------------------------------------------------------
# the engine against the reference's ContinuousEngine.run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, dict(speculate_k=2, draft_layers=0), dict(speculate_k=2),
    dict(prefill_batch=2), dict(speculate_k=3, draft_layers=0,
                                prefill_batch=2)],
    ids=["plain", "spec2-draft0", "spec2-full", "prefill2",
         "spec3-prefill2"])
def test_greedy_tokens_and_stats_equal_reference(kw):
    jcfg, cfg, jparams, params = _setup()
    reqs = _trace(cfg)
    jeng, eng = _engines(jcfg, cfg, **kw)
    want = jeng.run(jparams, _jtrace(reqs))
    got = eng.run(params, reqs)
    assert sorted(got["results"]) == sorted(want["results"])
    for rid, w in want["results"].items():
        g = got["results"][rid]
        assert g.tokens == [int(t) for t in w.tokens], rid
        assert (g.admitted_step, g.finished_step) == \
            (w.admitted_step, w.finished_step)
    assert got["stats"] == want["stats"]
    assert eng.num_executables == jeng.num_executables
    if kw.get("prefill_batch"):
        assert any("x" in k for k in got["stats"]["dispatches"])


def _positions(a, page_ax, pages):
    """A pool leaf's rows of ``pages``, in order: (positions, ...)."""
    x = np.take(a, pages, axis=page_ax)
    x = x.reshape(x.shape[:page_ax] + (-1,) + x.shape[page_ax + 2:])
    return np.moveaxis(x, page_ax, 0)


def test_speculative_tokens_equal_plain_and_rollback_is_clean():
    """The speculative run emits the plain run's tokens.  With the same
    admissions its final pools equal the plain run's bit for bit at every
    committed position, equal the reference's speculative pools within
    1e-5 everywhere outside scratch page 0 (the same rows written, the
    same rows rolled back), and hold their initial zeros past the reach
    of the last window."""
    jcfg, cfg, jparams, params = _setup()
    reqs = [Request(rid=i, tokens=tuple(range(3 + 2 * i, 7 + 3 * i)),
                    arrival=0.0) for i in range(3)]
    k = 2
    _, plain = _engines(jcfg, cfg)
    jspec, spec = _engines(jcfg, cfg, speculate_k=k, draft_layers=0)
    r1 = plain.run(params, reqs)
    r2 = spec.run(params, reqs)
    jspec.run(jparams, _jtrace(reqs))
    st = r2["stats"]["speculative"]
    assert 0 < st["accepted"] < st["drafted"]       # accepts and rejects
    for rid in r1["results"]:
        assert r1["results"][rid].tokens == r2["results"][rid].tokens
    got, base = paged_cache_to_numpy(spec.pools), \
        paged_cache_to_numpy(plain.pools)
    want = jax.tree.map(np.asarray, jspec.pools)
    maxp = LAYOUT["max_pages_per_slot"]
    for grp, page_ax in (("prologue", 0), ("blocks", 1)):
        for a, b, c in zip(jax.tree.leaves(got[grp]),
                           jax.tree.leaves(base[grp]),
                           jax.tree.leaves(want[grp])):
            sl = [slice(None)] * a.ndim
            sl[page_ax] = slice(1, None)     # page 0 = scratch, excluded
            np.testing.assert_allclose(a[tuple(sl)], c[tuple(sl)], rtol=0,
                                       atol=1e-5)
            for r in reqs:                   # slot i holds request i
                pages = np.arange(1 + r.rid * maxp, 1 + (r.rid + 1) * maxp)
                sa, sb = (_positions(x, page_ax, pages) for x in (a, b))
                done = r.prompt_len + len(r2["results"][r.rid].tokens) - 1
                reach = max(bucket_for(r.prompt_len, KW["buckets"]),
                            done + k)
                assert np.array_equal(sa[:done], sb[:done])
                assert sa[:r.prompt_len].any() and not sa[reach:].any()


@pytest.mark.parametrize("sampling", [
    SamplingParams(mode="sample", temperature=0.8),
    SamplingParams(mode="sample", temperature=1.2, top_k=20, top_p=0.9)])
def test_sampled_tokens_do_not_depend_on_slot_or_batch(sampling):
    """A request's sampled tokens are the same funnelled through one
    recycled slot, run alone, or sharing a batch; a refilled slot draws
    from its new request's streams, not the retired one's."""
    _, cfg, _, params = _setup()
    lay = PagedCacheLayout(**LAYOUT)
    kw = dict(layout=lay, max_new=5, buckets=(4, 8, 16), sampling=sampling,
              param_dtype=torch.float32, cache_dtype=torch.float32,
              device="cpu")
    reqs = [Request(rid=i, tokens=(7, 3, 9, 1, 4), arrival=0.0)
            for i in range(3)]
    one = ContinuousEngine(cfg, slots=1, **kw)
    funnel = one.run(params, reqs, seed=42)["results"]
    shared = ContinuousEngine(cfg, slots=3, **kw).run(params, reqs,
                                                      seed=42)["results"]
    for r in reqs:
        alone = one.run(params, [r], seed=42)["results"][r.rid]
        assert alone.tokens == funnel[r.rid].tokens == \
            shared[r.rid].tokens
    # the same prompt under three request ids: three streams
    assert len({tuple(funnel[r.rid].tokens) for r in reqs}) == 3
    other = one.run(params, reqs, seed=43)["results"]
    assert any(other[r.rid].tokens != funnel[r.rid].tokens for r in reqs)


def test_sampled_full_depth_draft_accepts_everything():
    """With the draft at full depth, p == q: every draft is accepted
    (u * q <= p), and the run is deterministic in its seed."""
    _, cfg, _, params = _setup()
    eng = ContinuousEngine(
        cfg, slots=2, layout=PagedCacheLayout(**LAYOUT), max_new=6,
        buckets=(4, 8, 16), sampling=SamplingParams(mode="sample",
                                                    temperature=0.9),
        speculate_k=2, draft_layers=cfg.num_blocks,
        param_dtype=torch.float32, cache_dtype=torch.float32, device="cpu")
    reqs = _trace(cfg, n=3, seed=5)
    a = eng.run(params, reqs, seed=1)
    b = eng.run(params, reqs, seed=1)
    st = a["stats"]["speculative"]
    assert st["accepted"] == st["drafted"] and st["acceptance_rate"] == 1.0
    assert all(a["results"][r].tokens == b["results"][r].tokens
               for r in a["results"])


def test_speculative_accept_greedy_rule_matches_reference():
    V, k = 8, 3
    rng = np.random.default_rng(7)
    vl = rng.standard_normal((3, k + 1, V)).astype(np.float32)
    t_hat = vl.argmax(-1)
    drafts = t_hat[:, :k].copy()
    drafts[0, 1] = (drafts[0, 1] + 1) % V       # row 0: mismatch at 1
    drafts[2, 0] = (drafts[2, 0] + 1) % V       # row 2: mismatch at 0
    ja, jt = jsampling.speculative_accept(
        jnp.asarray(vl), jnp.zeros((3, k, V)), jnp.asarray(drafts),
        jsampling.SamplingParams())
    acc, toks = speculative_accept(torch.from_numpy(vl),
                                   torch.zeros(3, k, V),
                                   torch.from_numpy(drafts),
                                   SamplingParams())
    assert acc.tolist() == [1, k, 0] == np.asarray(ja).tolist()
    assert np.array_equal(toks.numpy(), np.asarray(jt))


def test_speculative_accept_residual_rule():
    """p == q accepts every draft; a draft the target gives no mass is
    always rejected and replaced by a draw from the residual."""
    V, k = 6, 2
    logits = torch.randn(4, k + 1, V, generator=torch.Generator()
                         .manual_seed(0))
    sp = SamplingParams(mode="sample")
    drafts = torch.tensor([[1, 2]] * 4)
    streams = [(0, rid) for rid in range(4)]
    acc, _ = speculative_accept(logits, logits[:, :k], drafts, sp, streams,
                                [5] * 4)
    assert acc.tolist() == [k] * 4
    target = logits.clone()
    target[:, 0, 1] = -1e30                     # p_0(draft) = 0
    acc, toks = speculative_accept(target, logits[:, :k], drafts, sp,
                                   streams, [5] * 4)
    assert acc.tolist() == [0] * 4
    assert bool((toks[:, 0] != 1).all())


# ---------------------------------------------------------------------------
# scheduling and validation
# ---------------------------------------------------------------------------

def test_page_exhaustion_defers_admission():
    """With pages for one slot-load only, the second request waits for the
    first to retire, and still completes — as in the reference."""
    jcfg, cfg, jparams, params = _setup()
    lay = dict(page_size=8, num_pages=6, max_pages_per_slot=5)
    kw = dict(slots=2, max_new=3, buckets=(8, 16, 32))
    reqs = [Request(rid=0, tokens=tuple(range(6)), arrival=0.0),
            Request(rid=1, tokens=tuple(range(5)), arrival=0.0)]
    got = ContinuousEngine(cfg, layout=PagedCacheLayout(**lay),
                           param_dtype=torch.float32,
                           cache_dtype=torch.float32, device="cpu",
                           **kw).run(params, reqs)
    want = JEngine(jcfg, layout=JM.PagedCacheLayout(**lay),
                   kernel_config=REF, cache_dtype=jnp.float32,
                   **kw).run(jparams, _jtrace(reqs))
    res = got["results"]
    assert res[1].admitted_step > res[0].admitted_step
    assert all(len(r.tokens) == 3 for r in res.values())
    assert got["stats"] == want["stats"]


def test_eos_retires_a_slot_early():
    jcfg, cfg, jparams, params = _setup()
    reqs = _trace(cfg, n=5)
    _, eng = _engines(jcfg, cfg)
    first = eng.run(params, reqs)["results"]
    eos = first[0].tokens[1]
    jeng, eng = _engines(jcfg, cfg, eos_id=eos)
    got = eng.run(params, reqs)
    want = jeng.run(jparams, _jtrace(reqs))
    assert got["results"][0].tokens == first[0].tokens[:2]
    assert got["stats"] == want["stats"]
    for rid, w in want["results"].items():
        assert got["results"][rid].tokens == [int(t) for t in w.tokens]


@pytest.mark.parametrize("bad", [
    dict(draft_layers=1), dict(prefill_batch=0), dict(slots=0),
    dict(speculate_k=-1), dict(speculate_k=2, draft_layers=5),
    dict(buckets=(6, 8)), dict(buckets=(4, 32))])
def test_engine_validation_matches_reference(bad):
    jcfg, cfg, _, _ = _setup()
    kw = {**KW, **bad}
    with pytest.raises(ValueError):
        JEngine(jcfg, layout=JM.PagedCacheLayout(**LAYOUT), **kw)
    with pytest.raises(ValueError):
        ContinuousEngine(cfg, layout=PagedCacheLayout(**LAYOUT),
                         device="cpu", **kw)


def test_capacity_and_dtype_checks_raise():
    _, cfg, _, params = _setup()
    eng = ContinuousEngine(cfg, layout=PagedCacheLayout(**LAYOUT),
                           speculate_k=4, slots=2, max_new=19,
                           buckets=(4, 8), param_dtype=torch.float32,
                           cache_dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="speculate_k"):
        eng.run(params, [Request(rid=0, tokens=(1, 2), arrival=0.0)])
    bf = ContinuousEngine(cfg, layout=PagedCacheLayout(**LAYOUT),
                          param_dtype=torch.bfloat16,
                          cache_dtype=torch.bfloat16, device="cpu", **KW)
    with pytest.raises(TypeError, match="bfloat16"):
        bf.run(params, [Request(rid=0, tokens=(1, 2), arrival=0.0)])


def test_engine_defaults_to_f32_params_and_pools_as_the_reference():
    """Built without dtypes, the engine takes f32 params and keeps f32
    page pools, as the reference's does (``serve/continuous.py:105-106``),
    and serves the f32 params a trace."""
    jcfg, cfg, _, params = _setup()
    jeng = JEngine(jcfg, layout=JM.PagedCacheLayout(**LAYOUT), **KW)
    eng = ContinuousEngine(cfg, layout=PagedCacheLayout(**LAYOUT),
                           device="cpu", **KW)
    assert jeng.cache_dtype == jnp.float32
    assert eng.param_dtype == eng.cache_dtype == torch.float32
    from repro_torch.models.blocks import layer_caches
    leaves = [c[kv] for c in layer_caches(eng.pools) for kv in ("k", "v")]
    assert leaves and all(t.dtype == torch.float32 for t in leaves)
    out = eng.run(params, _trace(cfg, n=2))
    assert out["stats"]["requests"] == 2


def test_continuous_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "gemma3-1b", "--reduced", "--continuous",
                "--requests", "6", "--arrival-rate", "1.0", "--slots", "2",
                "--page-size", "4", "--prompt-len", "12", "--gen", "3",
                "--speculate-k", "2", "--draft-layers", "0",
                "--prefill-batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "continuous trace: 6 requests, 18 tokens" in out
    assert "speculative: k=2" in out
