"""The MoE family in the port (``repro_torch.models.moe``; grok-1-314b)
against the JAX reference, on the CPU.

- Both MoE configs equal the reference's field by field, full and
  ``reduced()``.
- The MoE layer against ``moe_apply`` on the reference's weights, in f32
  (max abs 1e-5) and bf16 (max abs 2^-5 max |want|: four bf16 steps at
  the output's scale, since each package rounds the three expert
  products, the activation, the gate product, the gating and each
  combine add to bf16 in its own order; the cases reach 0.4-1.0% of
  max |want|), with grok's gelu and deepseek's silu with
  a shared expert: a case with ties (duplicated tokens, and the zero
  columns every expert's row holds), a case whose capacity drops chosen
  tokens, a top-8 case over 16 experts, and grok's and deepseek's
  reduced routing.  The experts each token chose and the slots each
  expert kept equal the reference's exactly; each case prints its
  smallest margin between a chosen and a rejected score.  The aux loss
  and every gradient (input, router, experts, shared expert) against
  ``jax.grad`` at 1e-5, in f32.
- The combine adds each token's K terms in ascending expert order, the
  reference's sequential scatter-add, bit for bit in bf16.
- Reduced grok-1-314b (reference weights, random norm scales): prefill
  and decode logits against ``M.prefill`` / ``M.decode_step`` at 1e-4, a
  (B,) verify window, the paged decode with a free slot (its table row
  on the scratch page) against the reference's ``decode_mode="paged"``,
  ``loss_fn`` with the aux loss and every gradient at 1e-5, and one
  ``simulate_decentralized`` step against the reference engine's.

The reference runs through ``M.*`` directly (ROADMAP.md, queue 3: its
``make_engine(...).generate`` fails on the CPU under jax 0.9).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_moe_cases as cases
from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.serve import decode_logits_scan as jdecode_scan
from repro_torch.configs import ARCH_NAMES, MoEConfig, get_config
from repro_torch.convert import tree_from_jax
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.serve import PagedCacheLayout, decode_logits_scan
from torch_moe_cases import LAYER_TOL, REF, err as _err

ARCHS = ("grok-1-314b", "deepseek-v3-671b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small ops on reduced models: one intra-op thread keeps them
    from waiting on a pool oversubscribed by the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# configs
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


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

# name: (E, K, d_expert, shared, cf, act, how the tokens are made)
LAYER_CASES = {
    "ties": (4, 2, 24, 0, 1.25, "gelu", "duplicated"),
    "drops": (4, 2, 24, 0, 0.5, "gelu", "random"),
    "top8": (16, 8, 16, 1, 1.25, "silu", "random"),
    "grok-reduced": (4, 2, 128, 0, 1.25, "gelu", "random"),
    "deepseek-reduced": (4, 2, 128, 1, 1.25, "silu", "random"),
}
D_LAYER, B_LAYER, T_LAYER = 32, 2, 12


@functools.lru_cache(maxsize=None)
def _layer_case(name):
    E, K, F, shared, cf, act, how = LAYER_CASES[name]
    jcfg = jmoe.MoEConfig(num_experts=E, top_k=K, d_expert=F,
                          num_shared=shared, capacity_factor=cf)
    cfg = MoEConfig(num_experts=E, top_k=K, d_expert=F, num_shared=shared,
                    capacity_factor=cf)
    rng = np.random.default_rng(sum(map(ord, name)))

    def normal(*shape, scale=0.02):
        return jnp.asarray(scale * rng.standard_normal(shape,
                                                       dtype=np.float32))

    # ``moe_init``'s leaves, drawn with numpy; a router of unit scale, so
    # that routing is decided by the tokens
    jp = {"router": normal(D_LAYER, E, scale=1.0),
          "w_gate": normal(E, D_LAYER, F), "w_up": normal(E, D_LAYER, F),
          "w_down": normal(E, F, D_LAYER)}
    for s in range(shared):
        jp[f"shared_{s}"] = {"gate": {"w": normal(D_LAYER, F)},
                             "up": {"w": normal(D_LAYER, F)},
                             "down": {"w": normal(F, D_LAYER)}}
    x = rng.standard_normal((B_LAYER, T_LAYER, D_LAYER), dtype=np.float32)
    if how == "duplicated":
        # the second sequence repeats the first, and the first repeats its
        # first half: identical tokens score alike
        x[0, T_LAYER // 2:] = x[0, :T_LAYER // 2]
        x[1] = x[0]
    return jcfg, cfg, act, jp, x


def _port_layer(cfg, act, jp, dtype):
    layer = tmoe.MoE(D_LAYER, cfg, act=act, dtype=dtype, device="cpu")
    state = tree_from_jax(jax.tree.map(np.asarray, jp))
    layer.load_state_dict({k: v.to(dtype) for k, v in state.items()})
    return layer


@functools.partial(jax.jit, static_argnums=2)
def _reference_routing(jp, x, jcfg):
    """The reference's routing, its own code (``moe.py:62-79``) and its
    ``jax.lax.top_k``, on the same f32 router input."""
    N, E, K = x.shape[0], jcfg.num_experts, jcfg.top_k
    probs = jax.nn.softmax(x.astype(jnp.float32)
                           @ jp["router"].astype(jnp.float32), axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, K)
    if jcfg.normalize_gates:
        gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True),
                                            1e-9)
    sel = jnp.zeros((N, E), jnp.float32).at[
        jnp.arange(N)[:, None], gate_idx].set(gate_vals)
    C = min(max(1, int(N * K * jcfg.capacity_factor / E)), N)
    top_scores, top_tok = jax.lax.top_k(sel.T, C)
    return probs, gate_idx, sel, top_tok, top_scores > 0


def _margins(probs, gate_idx, sel, top_tok):
    """The smallest gap between a chosen and a rejected score: over the
    router's top-k (each token's k-th probability against its best
    rejected one) and over the capacity's top-C (each expert's C-th kept
    score against its best dropped one), as (all, non-zero) minima."""
    gaps = []
    for n in range(probs.shape[0]):
        rest = np.delete(probs[n], gate_idx[n])
        if rest.size:
            gaps.append(probs[n, gate_idx[n]].min() - rest.max())
    for e in range(sel.shape[1]):
        rest = np.delete(sel[:, e], top_tok[e])
        if rest.size:
            gaps.append(sel[top_tok[e], e].min() - rest.max())
    gaps = np.asarray(gaps)
    nz = gaps[gaps > 0]
    return float(gaps.min()), float(nz.min()) if nz.size else None


@pytest.mark.parametrize("case", LAYER_CASES)
def test_routing_matches_reference_exactly(case):
    """The experts each token chose (best first) and the tokens each
    expert kept, slot by slot, equal the reference's."""
    jcfg, cfg, act, jp, x = _layer_case(case)
    xf = x.reshape(-1, D_LAYER)
    probs, gate_idx, sel, top_tok, keep = map(np.asarray, _reference_routing(
        jp, jnp.asarray(xf), jcfg))
    r = tmoe.route(torch.from_numpy(xf), torch.from_numpy(
        np.array(jp["router"])), cfg)
    assert np.array_equal(r.gate_idx.numpy(), gate_idx)
    assert np.array_equal(r.top_tok.numpy(), top_tok)
    assert np.array_equal(r.keep.numpy(), keep)
    assert _err(r.probs, probs) <= 1e-6
    low, low_nz = _margins(probs, gate_idx, sel, top_tok)
    chosen = int((sel > 0).sum())
    print(f"[{case}] smallest chosen-rejected margin {low:.3e} (non-zero "
          f"{low_nz}); {chosen - int(keep.sum())} of {chosen} chosen slots "
          f"dropped")
    if case == "ties":
        assert low == 0.0      # the duplicated tokens tie
    if case == "drops":
        assert int(keep.sum()) < chosen


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", LAYER_CASES)
def test_moe_layer_matches_reference(case, dtype):
    jcfg, cfg, act, jp, x = _layer_case(case)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jpd = jax.tree.map(lambda a: a.astype(jdt), jp)
    want, want_aux = jax.jit(lambda p, x: jmoe.moe_apply(p, x, jcfg, act))(
        jpd, jnp.asarray(x).astype(jdt))
    layer = _port_layer(cfg, act, jp, tdt)
    got, aux = layer(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and aux.dtype == torch.float32
    tol = LAYER_TOL if dtype == "float32" else \
        2.0 ** -5 * float(np.abs(np.asarray(want, np.float32)).max())
    assert _err(_np(got), want) <= tol
    assert _err(aux.detach(), want_aux) <= LAYER_TOL


@pytest.mark.parametrize("case", ["ties", "drops", "top8"])
def test_moe_gradients_match_reference(case):
    """``jax.grad`` of sum(y * w) + aux through the router, the top-k's
    values, the gather, the expert products, the gates and the shared
    experts, against autograd, in f32."""
    jcfg, cfg, act, jp, x = _layer_case(case)
    w = np.random.default_rng(3).standard_normal(x.shape, dtype=np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_apply(p, x, jcfg, act)
        return jnp.sum(y * w) + aux

    want_p, want_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jp, jnp.asarray(x))
    layer = _port_layer(cfg, act, jp, torch.float32)
    params = {k: v.clone().requires_grad_()
              for k, v in layer.state_dict().items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = torch.func.functional_call(layer, params, (xt,))
    loss = torch.sum(y * torch.from_numpy(w)) + aux
    grads = torch.autograd.grad(loss, [xt] + list(params.values()))
    assert _err(grads[0], want_x) <= LAYER_TOL
    want = tree_from_jax(jax.tree.map(np.asarray, want_p))
    assert set(want) == set(params)
    for k, g in zip(params, grads[1:]):
        assert _err(g, want[k]) <= LAYER_TOL, k


def test_combine_is_the_sequential_scatter_in_bf16():
    """The (N, K) table adds each token's terms in ascending expert order,
    from zero, in bf16: the sequential expert-major scatter-add's bits,
    and the same bits on every call."""
    rng = np.random.default_rng(9)
    E, C, N, D = 16, 5, 12, 8
    ye = torch.from_numpy(rng.standard_normal((E, C, D),
                                              dtype=np.float32)).bfloat16()
    top_tok = torch.from_numpy(np.stack([rng.permutation(N)[:C]
                                         for _ in range(E)]))
    gate_idx = torch.from_numpy(np.stack([rng.permutation(E)[:8]
                                          for _ in range(N)]))
    chosen = torch.zeros(E, N, dtype=torch.bool)
    chosen[gate_idx, torch.arange(N)[:, None]] = True
    keep = chosen.gather(1, top_tok)
    r = tmoe.Routing(None, None, gate_idx, None, top_tok, keep)
    table = tmoe.combine_table(r)
    got = tmoe.combine(ye, table)
    want = torch.zeros(N, D, dtype=torch.bfloat16)
    for e in range(E):                  # the reference's scatter order
        for c in range(C):
            if keep[e, c]:
                n = int(top_tok[e, c])
                want[n] = want[n] + ye[e, c]
    assert torch.equal(got, want)
    assert torch.equal(tmoe.combine(ye, table), got)
    assert int((table == E * C).sum()) == int(chosen.sum() - keep.sum())


def test_top_k_puts_the_lower_index_first_on_a_tie():
    x = torch.tensor([[0.0, 1.0, 0.0, 1.0, 0.5, 0.0]])
    vals, idx = tmoe.top_k(x, 5)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x.numpy()), 5)
    assert idx.tolist() == np.asarray(want_i).tolist() == [[1, 3, 4, 0, 2]]
    assert np.array_equal(vals.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("n,want", [(4, 1), (24, 7), (2, 1), (4096, 1280)])
def test_capacity_is_the_references(n, want):
    cfg = get_config("grok-1-314b").moe
    assert tmoe.capacity(n, cfg) == want


# ---------------------------------------------------------------------------
# reduced grok-1-314b
# ---------------------------------------------------------------------------

def test_grok_prefill_decode_and_verify_match_reference():
    cases.prefill_decode("grok-1-314b")


def test_grok_paged_decode_with_a_free_slot_matches_reference():
    """Teacher-forced paged decode of three slots, the third free (its
    block-table row on the scratch page 0, as the continuous engine's
    idle slots): its dummy tokens route through the experts with the
    others', in both packages, and every slot's logits agree."""
    jcfg, cfg, jparams, tparams = cases.pair("grok-1-314b")
    B, T = 3, 6
    lay = dict(page_size=4, num_pages=6, max_pages_per_slot=2)
    table = np.array([[1, 2], [4, 3], [0, 0]], np.int32)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, T))
    tokens[2] = 0
    pools = TM.init_paged_cache(cfg, PagedCacheLayout(**lay), torch.float32,
                                "cpu")
    lp, _ = decode_logits_scan(
        cfg, tparams, pools, torch.from_numpy(tokens),
        torch.zeros(B, dtype=torch.int64), decode_mode="paged",
        block_table=torch.from_numpy(table))
    jpools = JM.init_paged_cache(jcfg, JM.PagedCacheLayout(**lay),
                                 jnp.float32)
    jl, _ = jdecode_scan(jcfg, jparams, jpools, jnp.asarray(tokens),
                         jnp.zeros((B,), jnp.int32), decode_mode="paged",
                         block_table=jnp.asarray(table), kernel_config=REF)
    assert _err(lp, jl) <= cases.MODEL_TOL


def test_grok_loss_and_gradients_match_reference():
    grads = cases.loss_and_grads("grok-1-314b")
    assert any(k.endswith("moe.router") for k in grads)


def test_grok_simulation_step_matches_reference():
    cases.sim_step("grok-1-314b")


def test_serve_launcher_runs_grok_on_the_cpu(capsys):
    from repro_torch.launch import serve as S
    S.main(["--arch", "grok-1-314b", "--reduced", "--continuous",
            "--requests", "3", "--slots", "2", "--page-size", "4",
            "--prompt-len", "6", "--gen", "3", "--device", "cpu"])
    assert "continuous trace: 3 requests, 9 tokens" in capsys.readouterr().out
