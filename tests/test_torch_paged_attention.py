"""The port's plain paged attention (``ref.paged_sdpa_ref`` behind
``ops.paged_sdpa``) against the reference's ``ref.paged_sdpa_ref`` and
its ``paged_flash_attention_pallas`` in interpret mode, on the CPU.

Inputs are made with numpy from a seed and handed to both sides, over
GQA, MQA and MHA heads, hd != hd_v, a sliding window, softcap, ragged
per-slot ``q_start`` / ``k_valid_len`` and page sizes 8 and 16.
Tolerances: f32 max abs 1e-5 (both sides sum in f32, in other orders),
as ``tests/test_torch_flash_attention.py``; bf16 element by element
1e-5 + 2^-7 |reference|, one bf16 rounding step, since each side rounds
its own f32 result to bf16 once.  Two contracts are bitwise: the paged
version equals the dense version row by row over a dense cache holding
the same bits (gathering is indexing), and a (k+1)-row verify window
equals k+1 one-row calls.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import paged_flash_attention_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

# (H, KV, hd, hd_v)
HEADS = {"gqa": (8, 2, 32, 32), "mqa": (4, 1, 32, 32),
         "mha": (4, 4, 32, 32), "hd!=hd_v": (4, 2, 64, 32)}


def _case(seed, *, B, Tq, H, KV, hd, hd_v, ps, maxp, num_pages):
    """q, the pools, a block table of distinct pages (page 0 unused) and
    the dense cache holding the same values at the same positions."""
    rng = np.random.default_rng(seed)
    S = maxp * ps
    q = rng.standard_normal((B, Tq, H, hd), dtype=np.float32)
    kd = rng.standard_normal((B, S, KV, hd), dtype=np.float32)
    vd = rng.standard_normal((B, S, KV, hd_v), dtype=np.float32)
    table = (rng.permutation(num_pages - 1)[:B * maxp] + 1).reshape(
        B, maxp).astype(np.int32)
    kp = np.zeros((num_pages, ps, KV, hd), np.float32)
    vp = np.zeros((num_pages, ps, KV, hd_v), np.float32)
    for b in range(B):
        for j in range(maxp):
            kp[table[b, j]] = kd[b, j * ps:(j + 1) * ps]
            vp[table[b, j]] = vd[b, j * ps:(j + 1) * ps]
    return q, kp, vp, table, kd, vd


def _torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _check(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == torch.float32:
        assert float(np.max(np.abs(got - want))) <= 1e-5
    else:
        tol = 1e-5 + 2.0 ** -7 * np.abs(want)
        assert bool(np.all(np.abs(got - want) <= tol)), \
            float(np.max(np.abs(got - want) / tol))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("window,softcap", [(None, None), (5, None),
                                            (None, 20.0)])
@pytest.mark.parametrize("heads", list(HEADS))
def test_paged_ref_matches_reference(heads, window, softcap, ps, dtype):
    """Ragged slots: a decode row, a verify window across a page
    boundary and a slot whose tail page is partly filled; the pages past
    ``k_valid_len`` hold NaN on the port's side, zeros on the
    reference's (real caches are zero-filled; see ROADMAP queue 3)."""
    H, KV, hd, hd_v = HEADS[heads]
    B, Tq, maxp = 3, 4, 3
    q, kp, vp, table, _, _ = _case(ps + (window or 0), B=B, Tq=Tq, H=H,
                                   KV=KV, hd=hd, hd_v=hd_v, ps=ps,
                                   maxp=maxp, num_pages=2 * B * maxp)
    q_start = np.array([ps - 2, 2 * ps - 1, 0], np.int32)
    k_valid = q_start + Tq
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jargs = [jnp.asarray(a).astype(jdt) for a in (q, kp, vp)]
    kw = dict(window=window, softcap=softcap)
    want = jref.paged_sdpa_ref(*jargs, jnp.asarray(table),
                               q_start=jnp.asarray(q_start),
                               k_valid_len=jnp.asarray(k_valid), **kw)
    # NaN everywhere no valid key lives: page 0 and the unused pages
    kn, vn = kp.copy(), vp.copy()
    used = np.zeros(kp.shape[0], bool)
    for b in range(B):
        for s in range(k_valid[b]):
            used[table[b, s // ps]] = True
    kn[~used] = np.nan
    vn[~used] = np.nan
    for b in range(B):                   # the partly filled tail pages
        j, r = divmod(int(k_valid[b]), ps)
        if r:
            kn[table[b, j], r:] = np.nan
            vn[table[b, j], r:] = np.nan
    got = ops.paged_sdpa(_torch(q, dtype), _torch(kn, dtype),
                         _torch(vn, dtype), torch.from_numpy(table),
                         q_start=torch.from_numpy(q_start),
                         k_valid_len=torch.from_numpy(k_valid), **kw)
    assert got.dtype == dtype and got.shape == (B, Tq, H, hd_v)
    _check(got, want, dtype)


@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("heads", ["gqa", "mqa", "hd!=hd_v"])
def test_paged_ref_matches_interpret_kernel(heads, ps):
    H, KV, hd, hd_v = HEADS[heads]
    B, Tq, maxp = 2, 3, 3
    q, kp, vp, table, _, _ = _case(3, B=B, Tq=Tq, H=H, KV=KV, hd=hd,
                                   hd_v=hd_v, ps=ps, maxp=maxp,
                                   num_pages=B * maxp + 2)
    q_start = np.array([ps + 3, 1], np.int32)
    k_valid = q_start + Tq
    want = paged_flash_attention_pallas(
        jnp.asarray(q).transpose(0, 2, 1, 3), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(table), jnp.asarray(q_start),
        jnp.asarray(k_valid), window=6, interpret=True).transpose(0, 2, 1, 3)
    got = ops.paged_sdpa(torch.from_numpy(q), torch.from_numpy(kp),
                         torch.from_numpy(vp), torch.from_numpy(table),
                         q_start=torch.from_numpy(q_start),
                         k_valid_len=torch.from_numpy(k_valid), window=6)
    _check(got, want, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", list(HEADS))
def test_paged_equals_dense_bitwise(heads, dtype):
    """Against a dense cache holding the same bits, each row of the paged
    version equals the dense version's one-row call bit for bit — the
    reference's dense-vs-paged contract."""
    H, KV, hd, hd_v = HEADS[heads]
    B, Tq, ps, maxp = 2, 3, 8, 3
    q, kp, vp, table, kd, vd = _case(1, B=B, Tq=Tq, H=H, KV=KV, hd=hd,
                                     hd_v=hd_v, ps=ps, maxp=maxp,
                                     num_pages=B * maxp + 1)
    q_start = torch.tensor([5, 17])
    k_valid = q_start + Tq
    kw = dict(window=7, softcap=30.0)
    got = ops.paged_sdpa(_torch(q, dtype), _torch(kp, dtype),
                         _torch(vp, dtype), torch.from_numpy(table),
                         q_start=q_start, k_valid_len=k_valid, **kw)
    for i in range(Tq):
        want = ops.sdpa(_torch(q, dtype)[:, i:i + 1], _torch(kd, dtype),
                        _torch(vd, dtype), q_pos0=q_start + i,
                        k_valid_len=k_valid, **kw)
        assert torch.equal(got[:, i:i + 1], want)


@pytest.mark.parametrize("window,softcap", [(None, None), (4, 30.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_window_equals_one_row_calls_bitwise(dtype, window,
                                                    softcap):
    """A (k+1)-row verify call at q_start with k_valid = q_start + k + 1
    equals k+1 decode calls at q_start + i with k_valid = q_start + i + 1,
    bit for bit: what makes greedy speculative decoding lossless."""
    H, KV, hd, hd_v = HEADS["mqa"]
    B, k, ps, maxp = 3, 4, 8, 4
    q, kp, vp, table, _, _ = _case(2, B=B, Tq=k + 1, H=H, KV=KV, hd=hd,
                                   hd_v=hd_v, ps=ps, maxp=maxp,
                                   num_pages=B * maxp + 1)
    q_start = torch.tensor([0, 6, 20])
    args = (_torch(q, dtype), _torch(kp, dtype), _torch(vp, dtype),
            torch.from_numpy(table))
    kw = dict(window=window, softcap=softcap)
    verify = ops.paged_sdpa(*args, q_start=q_start,
                            k_valid_len=q_start + k + 1, **kw)
    for i in range(k + 1):
        one = ops.paged_sdpa(args[0][:, i:i + 1], *args[1:],
                             q_start=q_start + i,
                             k_valid_len=q_start + i + 1, **kw)
        assert torch.equal(verify[:, i:i + 1], one), i
