"""Multi-head Latent Attention and the rest of deepseek-v3-671b in the port
(``repro_torch.models.mla``, shared experts, MTP, the untied head)
against the JAX reference, on the CPU.

- The MLA layer against ``mla_apply`` on the reference's weights (norm
  scales random) in its three branches: no cache, the dense latent cache
  at an int index, and per-request (B,) positions, outputs and the
  written ``ckv`` / ``krope`` rows within 1e-5 in f32, with and without a
  softcap.
- Reduced deepseek-v3-671b (a dense prologue layer, 2 MoE blocks with a
  shared expert, MTP, ``lm_head``): prefill, decode and a (B,) verify
  window against ``M.prefill`` / ``M.decode_step`` at 1e-4, ``loss_fn``
  (aux, MTP, ``lm_head``) and every gradient at 1e-5, and one
  ``simulate_decentralized`` step against the reference engine's.
- The fixed-batch speculative engine rolls back MLA's latent rows: in
  every round, the ``ckv`` / ``krope`` rows it did not keep equal the
  snapshot taken before the round bit for bit, and after the last round
  every row past the last kept position holds its initial zeros.
- ``convert`` carries ``lm_head.w``, ``mtp.*`` (outside the blocks, not
  split) and the (num_blocks, E, D, F) expert leaves (split by block)
  across, and stacking the port's tensors back gives the reference's
  leaves bit for bit.
- The paged cache refuses MLA with the reference's error.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_moe_cases as cases
from repro.configs import get_config as jget_config
from repro.models import mla as jmla
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.convert import tree_from_jax
from repro_torch.models import model as TM
from repro_torch.models.blocks import layer_caches
from repro_torch.models.mla import MLA
from repro_torch.serve import ContinuousEngine, PagedCacheLayout, make_engine
from torch_moe_cases import LAYER_TOL, REF, err

ARCH = "deepseek-v3-671b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small ops on reduced models: one intra-op thread keeps them
    from waiting on a pool oversubscribed by the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the MLA layer
# ---------------------------------------------------------------------------

D, H, B, S = 64, 4, 2, 12


def _mla_kw():
    m = get_config(ARCH).reduced().mla
    return dict(q_lora_rank=m.q_lora_rank, kv_lora_rank=m.kv_lora_rank,
                qk_nope_dim=m.qk_nope_dim, qk_rope_dim=m.qk_rope_dim,
                v_head_dim=m.v_head_dim)


def _mla_layer():
    rng = np.random.default_rng(8)
    jp = jmla.mla_init(jax.random.PRNGKey(2), D, H, jnp.float32, **_mla_kw())
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(0.3 * rng.standard_normal(
            a.shape, dtype=np.float32)) if path[-1].key == "scale" else a,
        jp)
    layer = MLA(D, H, get_config(ARCH).reduced().mla, dtype=torch.float32,
                device="cpu")
    layer.load_state_dict(tree_from_jax(jax.tree.map(np.asarray, jp)))
    return jp, layer


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("branch", ["no-cache", "int-index", "per-request"])
def test_mla_layer_matches_reference(branch, softcap):
    jp, layer = _mla_layer()
    m = _mla_kw()
    rng = np.random.default_rng(9)
    T = 3 if branch != "no-cache" else 7
    x = rng.standard_normal((B, T, D), dtype=np.float32)
    cache = index = None
    if branch != "no-cache":
        # earlier rows already in the cache, the rest zeros
        cache = {"ckv": rng.standard_normal((B, S, m["kv_lora_rank"]),
                                            dtype=np.float32),
                 "krope": rng.standard_normal((B, S, m["qk_rope_dim"]),
                                              dtype=np.float32)}
        index = 5 if branch == "int-index" else np.array([6, 4], np.int32)
        for a in cache.values():
            a[:, 9:] = 0.0
    want, wcache = jax.jit(lambda p, x, c, i: jmla.mla_apply(
        p, x, n_heads=H, cache=c, cache_index=i, softcap=softcap,
        kernel_config=REF, **m))(
        jp, jnp.asarray(x),
        None if cache is None else jax.tree.map(jnp.asarray, cache),
        None if index is None else jnp.asarray(index))
    tcache = None if cache is None else {k: torch.from_numpy(v.copy())
                                         for k, v in cache.items()}
    tindex = torch.from_numpy(index).long() \
        if isinstance(index, np.ndarray) else index
    with torch.inference_mode():
        got = layer(torch.from_numpy(x), softcap=softcap, cache=tcache,
                    cache_index=tindex)
    assert err(got, want) <= LAYER_TOL
    if cache is not None:
        for k in ("ckv", "krope"):
            assert err(tcache[k], wcache[k]) <= LAYER_TOL, k


# ---------------------------------------------------------------------------
# reduced deepseek-v3-671b
# ---------------------------------------------------------------------------

def test_deepseek_prefill_decode_and_verify_match_reference():
    _, tc = cases.prefill_decode(ARCH)
    cfg = get_config(ARCH).reduced()
    assert all(set(c) == {"ckv", "krope"} for c in layer_caches(tc))
    assert len(list(layer_caches(tc))) == cfg.num_layers


def test_deepseek_loss_and_gradients_match_reference():
    grads = cases.loss_and_grads(ARCH)
    for key in ("lm_head.w", "mtp.norm.scale", "mtp.layer.attn.wkv_b.w",
                "stack.blocks.1.0.moe.shared_0.down.w",
                "stack.blocks.0.0.moe.router"):
        assert float(grads[key].abs().max()) > 0.0, key


def test_deepseek_simulation_step_matches_reference():
    cases.sim_step(ARCH)


def test_speculative_engine_rolls_back_the_latent_cache(monkeypatch):
    """Self-speculative rounds (k = 2, a draft of 1 of 2 blocks) that
    reject drafts.  In every round, every layer's ``ckv`` / ``krope`` row
    the round did not keep equals the snapshot taken before the round bit
    for bit (also where the draft or the verify had written it), the kept
    rows are the verify's, and no row outside the round's window changes;
    at the end, every row past the last kept position is still zero."""
    import sys

    from repro_torch import trace
    _, cfg, _, params = cases.pair(ARCH)
    P, N = 5, 7
    tokens = torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (B, P)))
    eng = make_engine(cfg, batch=B, prompt_len=P, max_new=N, speculate_k=2,
                      draft_layers=1, param_dtype=torch.float32,
                      cache_dtype=torch.float32, device="cpu")
    seen, rolled = {}, []

    def copies(f):
        return [{n: c[n].clone() for n in c} for c in f["layers"]]

    def mark(name):
        f = sys._getframe(1).f_locals       # the engine's round
        if name == "round":
            seen["before"] = copies(f)
        elif name == "accept":
            seen["verified"] = copies(f)
        elif name == "end":
            rows, win, keep = f["rows"], f["win"], f["keep"]
            for c, before, verified in zip(f["layers"], seen["before"],
                                           seen["verified"]):
                for n in ("ckv", "krope"):
                    now = c[n].clone()
                    assert torch.equal(now[rows, win][keep],
                                       verified[n][rows, win][keep]), n
                    assert torch.equal(now[rows, win][~keep],
                                       before[n][rows, win][~keep]), n
                    rolled.append(not torch.equal(
                        verified[n][rows, win][~keep],
                        before[n][rows, win][~keep]))
                    now[rows, win] = before[n][rows, win]
                    assert torch.equal(now, before[n]), n

    monkeypatch.setattr(trace, "mark", mark)
    res = eng.generate_with_state(params, {"tokens": tokens})
    assert int(res.spec.accepted.sum()) < int(res.spec.drafted.sum())
    assert any(rolled)       # a round restored rows its verify had written
    lim = P + N - 1          # the last emitted token's row is not written
    for c in layer_caches(res.caches):
        assert set(c) == {"ckv", "krope"}
        for n in ("ckv", "krope"):
            assert not bool(c[n][:, lim:].any()), n
            assert bool(c[n][:, :lim].abs().sum(-1).gt(0).all()), n


# ---------------------------------------------------------------------------
# convert and the paged cache
# ---------------------------------------------------------------------------

def test_convert_round_trip_of_untied_mtp_and_expert_leaves():
    jcfg, cfg, jparams, tparams = cases.pair(ARCH)
    state = tparams.state_dict()
    flat = tree_from_jax(jax.tree.map(np.asarray, jparams))
    assert set(state) == set(flat)
    assert all(torch.equal(state[k], v) for k, v in flat.items())
    E, F = cfg.moe.num_experts, cfg.moe.d_expert
    assert state["lm_head.w"].shape == (cfg.d_model, cfg.vocab_size)
    assert state["stack.blocks.1.0.moe.w_gate"].shape == (E, cfg.d_model, F)
    assert state["stack.blocks.1.0.moe.w_down"].shape == (E, F, cfg.d_model)
    assert any(k.startswith("mtp.layer.attn.") for k in state)
    # back to the reference's tree: blocks stacked, the rest as they are
    leaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in leaves:
        name = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        if name.startswith("stack.blocks."):
            pos, rest = name[len("stack.blocks."):].split(".", 1)
            back = np.stack([state[f"stack.blocks.{b}.{pos}.{rest}"].numpy()
                             for b in range(cfg.num_blocks)])
        else:
            back = state[name].numpy()
        assert np.array_equal(back, np.asarray(leaf)), name


def test_paged_cache_refuses_mla_as_the_reference():
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    with pytest.raises(NotImplementedError) as want:
        JM.init_paged_cache(jcfg, JM.PagedCacheLayout(), jnp.float32)
    with pytest.raises(NotImplementedError) as got:
        TM.init_paged_cache(cfg, PagedCacheLayout(), torch.float32, "cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="MLA"):
        ContinuousEngine(cfg, slots=2, layout=PagedCacheLayout(), max_new=2,
                         device="cpu")


def test_serve_launcher_runs_deepseek_on_the_cpu(capsys):
    from repro_torch.launch import serve as S
    S.main(["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
            "6", "--gen", "3", "--speculate-k", "2", "--device", "cpu"])
    assert "steady state on cpu" in capsys.readouterr().out
