"""The dense model zoo in the port (``repro_torch.configs`` gemma2-2b,
granite-8b and qwen1.5-4b; QKV biases; ``remat=``) against the JAX
reference, on the CPU.

Each arch runs at ``reduced()``, with the reference's weights carried
across by ``convert.params_from_jax`` (norm scales and QKV biases made
random, since both start at zero).  qwen1.5-4b runs twice: as
``reduced()`` gives it (4 q / 2 kv heads) and with 4 kv heads on both
sides (``dataclasses.replace``), its MHA layout.

- Configs equal the reference's field by field, full and reduced.
- Prefill and decode logits against ``M.prefill`` / ``M.decode_step``
  with the reference's plain attention at max abs 1e-4, and the port's
  paged decode equal to its dense decode bit for bit (the tolerances of
  ``tests/test_torch_model.py`` and ``tests/test_torch_continuous.py``).
- ``loss_fn`` and every gradient, the bias leaves included, against
  ``jax.value_and_grad`` of the reference's at max abs 1e-5.
- ``remat=True`` gradients equal ``remat=False`` ones bit for bit in f32,
  and the recompute runs each pattern block's attention once more.
- The distributed step on reduced granite-8b (the reference's own
  ``tests/test_dist.py`` arch): three gloo ranks with ``remat=True``
  against the reference's dense simulation within 2e-4 and the port's
  simulation engine within 1e-5 (``tests/test_torch_dist.py``).
- The attention layer with QKV biases and QK-norm against the
  reference's ``attn_apply`` (bias, then norm, then rope), and the two
  launchers on each arch.
"""
import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks
from repro.configs import get_config as jget_config
from repro.data import synthetic as jsynthetic
from repro.kernels.ops import KernelConfig
from repro.models import attention as jattention
from repro.models import model as JM
from repro.optim.decentralized import make_method as jmake
from repro.topology import TopologySpec as JSpec
from repro.topology import build_schedule as jbuild
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.convert import params_from_jax, stack_ranks, tree_from_jax
from repro_torch.dist import steps as tsteps
from repro_torch.kernels import ref
from repro_torch.launch import distributed as D
from repro_torch.launch import serve as S
from repro_torch.launch import train as T
from repro_torch.models import model as TM
from repro_torch.models.attention import Attention
from repro_torch.optim.decentralized import make_method
from repro_torch.serve import PagedCacheLayout, PagePool, decode_logits_scan
from repro_torch.sim.engine import simulate_decentralized
from repro_torch.topology import TopologySpec

ZOO = ("gemma2-2b", "granite-8b", "qwen1.5-4b")
CASES = ZOO + ("qwen1.5-4b/mha",)
LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
REF = KernelConfig(backend="ref")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small ops on reduced models: one intra-op thread keeps them
    from waiting on a pool oversubscribed by the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _err(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float32)
                               - np.asarray(want, np.float32))))


def _configs(case):
    arch, _, variant = case.partition("/")
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    if variant == "mha":
        jcfg, cfg = (dataclasses.replace(c, num_kv_heads=c.num_heads)
                     for c in (jcfg, cfg))
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _pair(case):
    """The reference's reduced params (norm scales and biases random) and
    the port's model holding them."""
    jcfg, cfg = _configs(case)
    rng = np.random.default_rng(11)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(0.3 * rng.standard_normal(
            a.shape, dtype=np.float32)) if path[-1].key in ("scale", "b")
        else a, JM.init(jcfg, jax.random.PRNGKey(0), jnp.float32))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    return jcfg, cfg, jparams, tparams


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ZOO)
def test_config_matches_reference(arch, reduced):
    want, got = jget_config(arch), get_config(arch)
    if reduced:
        want, got = want.reduced(), got.reduced()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.num_layers == want.num_layers
    assert get_config(arch.replace("-", "_")) is get_config(arch)


def test_registry_lists_the_dense_zoo():
    assert ARCH_NAMES == ("gemma3-1b",) + ZOO + ("grok-1-314b",
                                                 "deepseek-v3-671b")
    with pytest.raises(NotImplementedError, match="gemma2-2b, granite-8b"):
        get_config("mamba2-2.7b")


@pytest.mark.parametrize("case", ["qwen1.5-4b", "qwen1.5-4b/mha"])
def test_bias_leaves_split_along_the_blocks(case):
    """Each projection's bias ``(num_blocks, d_out)`` in the reference
    becomes one ``(d_out,)`` tensor per block; ``wo`` has none."""
    _, cfg, jparams, tparams = _pair(case)
    state = tparams.state_dict()
    attn = jparams["stack"]["blocks"][0]["attn"]
    assert "b" not in attn["wo"]
    for name, width in (("wq", cfg.num_heads), ("wk", cfg.num_kv_heads),
                        ("wv", cfg.num_kv_heads)):
        b = np.asarray(attn[name]["b"])
        assert b.shape == (cfg.num_blocks, width * cfg.head_dim)
        for blk in range(cfg.num_blocks):
            assert np.array_equal(
                state[f"stack.blocks.{blk}.0.attn.{name}.b"].numpy(), b[blk])
    assert len(state) == len(jax.tree.leaves(jparams)) + sum(
        cfg.num_blocks - 1
        for _ in jax.tree.leaves(jparams["stack"]["blocks"]))


def test_attention_bias_then_norm_then_rope_matches_reference():
    """One attention layer with QKV biases and QK-norm (both at once, which
    no zoo config has) against ``attn_apply``: the biases are added before
    the norm and before rope."""
    d, H, KV, hd, B, T_ = 32, 4, 2, 16, 2, 7
    rng = np.random.default_rng(4)
    jp = jattention.attn_init(jax.random.PRNGKey(3), d, H, KV, hd,
                              jnp.float32, qkv_bias=True, qk_norm=True)
    jp = jax.tree.map(lambda a: a + jnp.asarray(0.3 * rng.standard_normal(
        a.shape, dtype=np.float32)), jp)
    x = rng.standard_normal((B, T_, d), dtype=np.float32)
    want, _ = jax.jit(lambda p, x: jattention.attn_apply(
        p, x, n_heads=H, n_kv=KV, head_dim=hd, rope_theta=1e4, window=3,
        softcap=20.0, kernel_config=REF))(jp, jnp.asarray(x))
    layer = Attention(d, H, KV, hd, qkv_bias=True, qk_norm=True,
                      dtype=torch.float32, device="cpu")
    layer.load_state_dict(tree_from_jax(jax.tree.map(np.asarray, jp)))
    got = layer(torch.from_numpy(x), rope_theta=1e4, window=3, softcap=20.0)
    assert _err(got.detach(), want) <= LAYER_TOL


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_logits_match_reference(case):
    """Prefill past the reduced window (4), then three decode steps, each
    against the reference's with its plain attention."""
    jcfg, cfg, jparams, tparams = _pair(case)
    B, P, steps = 2, 7, 3
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                               (B, P + steps))
    jl, jc, _ = jax.jit(lambda p, t: JM.prefill(
        jcfg, p, {"tokens": t}, P + steps, jnp.float32, kernel_config=REF))(
        jparams, jnp.asarray(tokens[:, :P]))
    tl, tc = TM.prefill(cfg, tparams, {"tokens": torch.from_numpy(
        tokens[:, :P])}, P + steps, torch.float32)
    assert tl.shape == (B, 1, cfg.vocab_size)
    assert _err(tl, jl) <= MODEL_TOL
    jdecode = jax.jit(lambda p, c, t, i: JM.decode_step(
        jcfg, p, c, t, i, kernel_config=REF))
    for i in range(P, P + steps):
        jl, jc = jdecode(jparams, jc, jnp.asarray(tokens[:, i:i + 1]),
                         jnp.int32(i))
        tl, tc = TM.decode_step(cfg, tparams, tc,
                                torch.from_numpy(tokens[:, i:i + 1]), i)
        assert _err(tl, jl) <= MODEL_TOL, i


@pytest.mark.parametrize("case", CASES)
def test_paged_decode_equals_dense_decode(case):
    """Teacher-forced decode over page pools (page 4, a slot's pages out
    of order) equals the dense cache's, bit for bit."""
    _, cfg, _, tparams = _pair(case)
    B, T_ = 2, 9
    lay = PagedCacheLayout(page_size=4, num_pages=9, max_pages_per_slot=3)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, T_)))
    dense = TM.init_cache(cfg, B, lay.max_seq, torch.float32, "cpu")
    ld, _ = decode_logits_scan(cfg, tparams, dense, tokens, 0)
    pools = TM.init_paged_cache(cfg, lay, torch.float32, "cpu")
    table = np.stack([PagePool(9).alloc(3) for _ in range(B)])
    table[1] = [8, 5, 6]
    lp, _ = decode_logits_scan(
        cfg, tparams, pools, tokens, torch.zeros(B, dtype=torch.int64),
        decode_mode="paged",
        block_table=torch.from_numpy(table.astype(np.int32)))
    assert torch.equal(lp, ld)


@pytest.mark.parametrize("arch", ZOO)
def test_serve_launchers_run_on_the_cpu(arch, capsys):
    S.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
            "6", "--gen", "3", "--device", "cpu"])
    S.main(["--arch", arch, "--reduced", "--continuous", "--requests", "3",
            "--slots", "2", "--page-size", "4", "--prompt-len", "6",
            "--gen", "3", "--speculate-k", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "steady state on cpu" in out
    assert "continuous trace: 3 requests, 9 tokens" in out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _batch(cfg, B=2, T_=12):
    return jsynthetic.token_batches(0, batch=B, seq=T_, vocab=cfg.vocab_size)


@pytest.mark.parametrize("case", CASES)
def test_loss_fn_and_gradients_match_reference(case):
    jcfg, cfg, jparams, tparams = _pair(case)
    batch = _batch(cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(jcfg, p, b, kernel_config=REF)[0]))(
        jparams, jax.tree.map(jnp.asarray, batch))
    params = {k: v.detach().clone().requires_grad_()
              for k, v in tparams.state_dict().items()}
    loss, _ = TM.loss_fn(cfg, params, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    assert _err(loss.detach(), jloss) <= LAYER_TOL
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    want = tree_from_jax(jax.tree.map(np.asarray, jgrads))
    assert set(grads) == set(want)
    assert any(k.endswith(".b") for k in want) == cfg.qkv_bias
    for k, g in want.items():
        assert _err(grads[k], g) <= LAYER_TOL, k


@pytest.mark.parametrize("case", CASES)
def test_remat_gradients_equal_bitwise(case, monkeypatch):
    """Checkpointed blocks give the same loss and gradients bit for bit;
    the backward runs each pattern block's attention once more (the
    plain version here, the flash kernel on the card)."""
    _, cfg, _, tparams = _pair(case)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    calls = []
    plain = ref.grouped_sdpa_ref
    monkeypatch.setattr(ref, "grouped_sdpa_ref",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    out = {}
    for remat in (False, True):
        params = {k: v.detach().clone().requires_grad_()
                  for k, v in tparams.state_dict().items()}
        calls.clear()
        loss, _ = TM.loss_fn(cfg, params, batch, remat=remat)
        forward = len(calls)
        grads = torch.autograd.grad(loss, list(params.values()))
        out[remat] = loss.detach(), grads, forward, len(calls)
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(a, b) for a, b in zip(out[True][1],
                                                 out[False][1]))
    blocks = cfg.num_blocks * len(cfg.pattern)
    assert out[False][2:] == (cfg.num_layers, cfg.num_layers)
    assert out[True][2:] == (cfg.num_layers, cfg.num_layers + blocks)


def test_remat_defaults_follow_the_reference():
    """The step checkpoints by default (``dist/steps.py:88``), the launcher
    at full width only (``launch/train.py:88``), ``loss_fn`` not at all;
    a forward over caches does not take it."""
    assert inspect.signature(tsteps.make_train_step).parameters[
        "remat"].default is True
    assert inspect.signature(TM.loss_fn).parameters["remat"].default is False
    assert T.TrainOptions().remat is True
    cfg = get_config("granite-8b").reduced()
    params = TM.init(cfg, seed=0, device="cpu")
    caches = TM.init_cache(cfg, 1, 4, torch.float32, "cpu")
    with pytest.raises(ValueError, match="no caches"):
        TM.backbone(cfg, params, torch.zeros(1, 2, dtype=torch.int64),
                    caches=caches, cache_index=0, remat=True)


@pytest.mark.parametrize("reduced", [False, True])
def test_train_launcher_remats_at_full_width_only(reduced, monkeypatch):
    seen = []
    monkeypatch.setattr(T, "launch", lambda opts, **kw: seen.append(opts)
                        or [{"losses": [0.0], "sent": {"bytes": 0}}])
    T.main(["--arch", "granite-8b", "--steps", "1", "--device", "cpu"]
           + (["--reduced"] if reduced else []))
    assert seen[0].remat is not reduced and seen[0].arch == "granite-8b"


DIST_N, DIST_STEPS, DIST_ETA, DIST_B, DIST_T = 3, 3, 0.05, 2, 16


@pytest.fixture(scope="module")
def granite_ranks(tmp_path_factory):
    """Three gloo CPU ranks of reduced granite-8b (f32) with ``remat=True``,
    from the reference's initial parameters."""
    jcfg = jget_config("granite-8b").reduced()
    jparams = JM.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    flat = {k: v.numpy() for k, v in
            tree_from_jax(jax.tree.map(np.asarray, jparams)).items()}
    per_rank = D.spawn_local(
        torch_dist_ranks.train, DIST_N,
        args=(flat, jcfg.num_blocks, None, DIST_STEPS, DIST_ETA, DIST_B,
              DIST_T, "dsgdm", "granite-8b", True),
        backend="gloo", device="cpu", timeout=300,
        init_method=f"file://{tmp_path_factory.mktemp('zoo')}/store")
    got = stack_ranks([{k: torch.from_numpy(v)
                        for k, v in r["params"].items()} for r in per_rank])
    return jcfg, jparams, flat, got


def _batches(step, vocab):
    raw = jsynthetic.token_batches(step, batch=DIST_N * DIST_B, seq=DIST_T,
                                   vocab=vocab)
    return {k: v.reshape(DIST_N, DIST_B, DIST_T) for k, v in raw.items()}


def _max_err(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    return max(_err(got[k], want[k]) for k in want)


def test_distributed_remat_step_matches_reference_simulation(granite_ranks):
    jcfg, jparams, _, got = granite_ranks
    method, sched = jmake("dsgdm"), jbuild(JSpec("base", DIST_N, 1))
    grad_fn = jax.jit(jax.vmap(jax.grad(
        lambda p, b: JM.loss_fn(jcfg, p, b, kernel_config=REF)[0])))
    step = jax.jit(lambda p, g, s, W: method.step(p, g, s, W, DIST_ETA))
    pn = jax.tree.map(lambda p: jnp.broadcast_to(p[None], (DIST_N,)
                                                 + p.shape) + 0.0, jparams)
    state = method.init(pn)
    for r in range(DIST_STEPS):
        batch = jax.tree.map(jnp.asarray, _batches(r, jcfg.vocab_size))
        pn, state = step(pn, grad_fn(pn, batch), state,
                         jnp.asarray(sched.W(r)))
    want = tree_from_jax(jax.tree.map(np.asarray, pn), node_axis=True)
    assert _max_err(got, want) < 2e-4


def test_distributed_remat_step_matches_port_simulation(granite_ranks):
    _, _, flat, got = granite_ranks
    cfg = get_config("granite-8b").reduced()
    res = simulate_decentralized(
        loss_fn=lambda p, b: TM.loss_fn(cfg, p, b)[0],
        params={k: torch.from_numpy(v) for k, v in flat.items()},
        method=make_method("dsgdm"),
        schedule=TopologySpec("base", DIST_N, 1),
        batches=lambda s: _batches(s, cfg.vocab_size), steps=DIST_STEPS,
        eta=DIST_ETA, device="cpu")
    assert _max_err(got, res.params) < 1e-5
