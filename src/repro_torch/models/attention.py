"""Attention: GQA/MQA with RoPE, sliding window, softcap, QK-norm and a
dense KV cache (port of ``repro/models/attention.py``).

:class:`Attention` is the reference's ``attn_init`` / ``attn_apply``.
It covers the no-cache path and two cache paths:

* ``"dus"``, a scalar ``cache_index``: the fresh K/V rows are written into
  the preallocated cache at ``cache_index`` and the queries attend over
  the whole cache with ``k_valid_len = cache_index + T`` masking the empty
  tail, through :func:`repro_torch.kernels.ops.sdpa`;
* ``"paged"``, a (B,) vector ``cache_index`` of per-slot write positions:
  the cache is a pair of page pools ``(P, ps, KV, hd)`` addressed through
  a (B, maxp) block table; the fresh rows are scattered to
  ``(table[b, pos // ps], pos % ps)`` and the queries attend through
  :func:`repro_torch.kernels.ops.paged_sdpa` with ``q_start =
  cache_index`` and ``k_valid_len = cache_index + T``.

Caches are updated in place — the port's caches are not copied each
step, which saves a whole-cache write per layer per token.  A vector
``cache_index`` in the ``"dus"`` mode (the reference's dense verify path)
and the ``"append_free"`` mode are not ported yet and raise.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops

from .layers import Dense, RMSNorm, rope


class Attention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 *, dtype, device, qk_norm: bool = False):
        super().__init__()
        self.n_heads, self.n_kv, self.head_dim = n_heads, n_kv, head_dim
        kw = dict(dtype=dtype, device=device)
        self.wq = Dense(d_model, n_heads * head_dim, **kw)
        self.wk = Dense(d_model, n_kv * head_dim, **kw)
        self.wv = Dense(d_model, n_kv * head_dim, **kw)
        self.wo = Dense(n_heads * head_dim, d_model, **kw)
        self.q_norm = RMSNorm(head_dim, **kw) if qk_norm else None
        self.k_norm = RMSNorm(head_dim, **kw) if qk_norm else None

    def forward(self, x, *, rope_theta=10000.0, window=None, softcap=None,
                scale=None, cache=None, cache_index=None, decode_mode="dus",
                block_table=None):
        """Causal self-attention.  x: (B, T, D).  With ``cache`` (dict k/v
        (B, S, KV, hd)) writes the fresh K/V at the int ``cache_index``
        (in place) and attends over the cache; with ``decode_mode="paged"``
        the cache is a pair of page pools (P, ps, KV, hd), ``cache_index``
        a (B,) tensor and ``block_table`` (B, maxp) int32.  Returns y
        (B, T, D)."""
        if decode_mode == "paged":
            return self._paged(x, rope_theta=rope_theta, window=window,
                               softcap=softcap, scale=scale, cache=cache,
                               cache_index=cache_index,
                               block_table=block_table)
        if decode_mode != "dus":
            raise NotImplementedError(
                f"decode_mode {decode_mode!r} is not ported to repro_torch "
                f"yet; see ROADMAP.md")
        if cache_index is not None and not isinstance(cache_index, int):
            raise NotImplementedError(
                "a per-slot vector cache_index over a dense cache is not "
                "ported yet; pass an int, or use decode_mode='paged'")
        B, T, _ = x.shape
        pos0 = 0 if cache_index is None else cache_index
        q, xk, xv = self._qkv(x, pos0 + torch.arange(T, device=x.device),
                              rope_theta)
        if cache is not None:
            k, v = cache["k"], cache["v"]
            if pos0 + T > k.shape[1]:
                raise ValueError(f"cache of {k.shape[1]} positions cannot "
                                 f"hold positions [{pos0}, {pos0 + T})")
            k[:, pos0:pos0 + T] = xk
            v[:, pos0:pos0 + T] = xv
            out = ops.sdpa(q, k, v, window=window, softcap=softcap,
                           scale=scale, q_pos0=pos0, k_valid_len=pos0 + T)
        else:
            out = ops.sdpa(q, xk, xv, window=window, softcap=softcap,
                           scale=scale, q_pos0=0)
        return self.wo(out.reshape(B, T, self.n_heads * self.head_dim))

    def _qkv(self, x, positions, rope_theta):
        B, T, _ = x.shape
        H, KV, hd = self.n_heads, self.n_kv, self.head_dim
        q = self.wq(x).reshape(B, T, H, hd)
        xk = self.wk(x).reshape(B, T, KV, hd)
        xv = self.wv(x).reshape(B, T, KV, hd)
        if self.q_norm is not None:        # QK-norm runs before rope
            q = self.q_norm(q)
            xk = self.k_norm(xk)
        return rope(q, positions, rope_theta), rope(xk, positions,
                                                    rope_theta), xv

    def _paged(self, x, *, rope_theta, window, softcap, scale, cache,
               cache_index, block_table):
        """The ``"paged"`` branch (``attention.py:200-226``): scatter the
        fresh K/V of slot b's positions ``cache_index[b] + [0, T)`` into
        its pages, in place, then attend over the pools.  Idle slots point
        their table rows at the scratch page 0.  T > 1 is a speculative
        verify window, which may straddle a page boundary."""
        if cache is None or block_table is None:
            raise ValueError("decode_mode='paged' needs the page pools and "
                             "a block_table")
        B, T, _ = x.shape
        idx = torch.as_tensor(cache_index, device=x.device).reshape(-1)
        if idx.shape != (B,):
            raise ValueError(f"paged cache_index must be ({B},), got "
                             f"{tuple(idx.shape)}")
        pos = idx.long()[:, None] + torch.arange(T, device=x.device)
        q, xk, xv = self._qkv(x, pos, rope_theta)
        k, v = cache["k"], cache["v"]
        ps = k.shape[1]
        page = block_table.long().gather(1, pos // ps)           # (B, T)
        slot = pos % ps
        k[page, slot] = xk.to(k.dtype)
        v[page, slot] = xv.to(v.dtype)
        out = ops.paged_sdpa(q, k, v, block_table, q_start=idx,
                             k_valid_len=idx + T, window=window,
                             softcap=softcap, scale=scale)
        return self.wo(out.reshape(B, T, self.n_heads * self.head_dim))
