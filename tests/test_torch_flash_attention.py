"""The port's plain attention (``repro_torch.kernels``) against the JAX
references: ``ref.grouped_sdpa_ref`` / ``grouped_sdpa_decode_ref`` /
``flash_attention_ref`` and ``flash_attention_pallas`` in interpret mode.

Inputs are made with numpy from a seed and handed to both sides.  The
tolerance is max abs 1e-5: both sides compute in f32 but sum in
different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

TOL = 1e-5


def _qkv(seed, B, Tq, S, H, KV, D, Dv):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, H, D), dtype=np.float32)
    k = rng.standard_normal((B, S, KV, D), dtype=np.float32)
    v = rng.standard_normal((B, S, KV, Dv), dtype=np.float32)
    return q, k, v


def _poison(a, valid):
    """Torch copy of ``a`` with every cache row at or past ``valid`` NaN."""
    t = torch.from_numpy(a.copy())
    t[:, valid:] = float("nan")
    return t


def _max_err(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float32)
                               - np.asarray(want, np.float32))))


@pytest.mark.parametrize("H,KV", [(4, 1), (4, 2), (4, 4)])
@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_sdpa_matches_grouped_ref_on_partial_cache(H, KV, window, softcap):
    """Queries at q_pos0 > 0 against a cache valid up to q_pos0 + Tq < S,
    whose tail holds NaN on the port's side (zeros on the reference's)."""
    B, Tq, S, D, q_pos0 = 2, 5, 13, 16, 3
    valid = q_pos0 + Tq
    q, k, v = _qkv(0, B, Tq, S, H, KV, D, D)
    k[:, valid:] = 0.0
    v[:, valid:] = 0.0
    want = jref.grouped_sdpa_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        softcap=softcap, q_pos0=q_pos0,
        k_valid_len=jnp.full((B,), valid, jnp.int32))
    got = ops.sdpa(torch.from_numpy(q), _poison(k, valid), _poison(v, valid),
                   window=window, softcap=softcap, q_pos0=q_pos0,
                   k_valid_len=valid)
    assert got.shape == (B, Tq, H, D)
    assert _max_err(got, want) <= TOL


@pytest.mark.parametrize("Tq,S,D,Dv", [
    (7, 7, 16, 16),     # square prefill
    (3, 11, 16, 16),    # ragged: last query aligned to the last key
    (1, 9, 32, 32),     # single-token decode shape
    (6, 10, 32, 16),    # Dv != D
])
def test_sdpa_ragged_and_value_dims(Tq, S, D, Dv):
    q, k, v = _qkv(1, 2, Tq, S, 4, 2, D, Dv)
    want = jref.grouped_sdpa_ref(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), window=5)
    got = ops.sdpa(*map(torch.from_numpy, (q, k, v)), window=5)
    assert got.shape == (2, Tq, 4, Dv)
    assert _max_err(got, want) <= TOL


def test_sdpa_per_batch_positions_match_decode_ref():
    """(B,) q_pos0 / k_valid_len tensors: per-request starts, as the
    kernel's q_start / k_valid operands take them."""
    B, Tq, S, H, KV, D = 3, 2, 12, 4, 1, 16
    q, k, v = _qkv(2, B, Tq, S, H, KV, D, D)
    starts = np.array([0, 4, 9], np.int32)
    valid = starts + Tq
    want = jref.grouped_sdpa_decode_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_start=jnp.asarray(starts), k_valid_len=jnp.asarray(valid),
        window=3, softcap=30.0)
    got = ops.sdpa(*map(torch.from_numpy, (q, k, v)), window=3, softcap=30.0,
                   q_pos0=torch.from_numpy(starts),
                   k_valid_len=torch.from_numpy(valid))
    assert _max_err(got, want) <= TOL


@pytest.mark.parametrize("H,KV,D,Dv,window,softcap,valid", [
    (4, 1, 16, 16, 4, None, 14),     # MQA, window, NaN-poisoned tail
    (4, 2, 16, 16, None, 30.0, None),
    (4, 4, 32, 16, 6, None, None),   # Dv != D
])
def test_flash_attention_matches_pallas_interpret(H, KV, D, Dv, window,
                                                  softcap, valid):
    """The (B, H, T, D) entry against the TPU kernel itself, run as
    tests/test_kernels.py runs it (interpret mode, small blocks)."""
    B, Tq, Tk = 2, 9, 20
    q, k, v = _qkv(3, B, Tq, Tk, H, KV, D, Dv)
    q_start = (valid or Tk) - Tq
    kv = Tk if valid is None else valid
    k[:, kv:] = 0.0
    v[:, kv:] = 0.0
    bhtd = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))  # noqa: E731
    want = flash_attention_pallas(
        bhtd(q), bhtd(k), bhtd(v), causal=True, window=window,
        softcap=softcap, q_start=jnp.full((B,), q_start, jnp.int32),
        k_valid_len=jnp.full((B,), kv, jnp.int32), interpret=True,
        block_q=8, block_k=16)
    tk = (_poison(k, kv) if valid else torch.from_numpy(k)).transpose(1, 2)
    tv = (_poison(v, kv) if valid else torch.from_numpy(v)).transpose(1, 2)
    got = ops.flash_attention(torch.from_numpy(q).transpose(1, 2), tk, tv,
                              window=window, softcap=softcap,
                              q_start=q_start, k_valid_len=kv)
    assert got.shape == (B, H, Tq, Dv)
    assert _max_err(got, want) <= TOL


@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (True, 3, 30.0), (False, None, None)])
def test_flash_attention_ref_matches_reference(causal, window, softcap):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 3, 6, 16), dtype=np.float32)
    k = rng.standard_normal((2, 3, 10, 16), dtype=np.float32)
    v = rng.standard_normal((2, 3, 10, 16), dtype=np.float32)
    want = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                    causal=causal, window=window,
                                    softcap=softcap)
    got = tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal, window=window,
                                   softcap=softcap)
    assert _max_err(got, want) <= TOL
