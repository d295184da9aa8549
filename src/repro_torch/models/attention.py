"""Attention: GQA/MQA/MHA with RoPE, sliding window, softcap, QK-norm,
optional QKV biases and a dense KV cache (port of
``repro/models/attention.py``).

:class:`Attention` is the reference's ``attn_init`` / ``attn_apply``.
It covers the no-cache path and these cache paths:

* ``"dus"``, a scalar ``cache_index``: the fresh K/V rows are written into
  the preallocated cache at ``cache_index`` and the queries attend over
  the whole cache with ``k_valid_len = cache_index + T`` masking the empty
  tail, through :func:`repro_torch.kernels.ops.sdpa`;
* a (B,) vector ``cache_index`` over a dense cache, the fixed-batch
  speculative engine's draft steps and verify window: the fresh rows of
  request b are scattered to ``(b, cache_index[b] + t)`` and the queries
  attend through :func:`repro_torch.kernels.ops.sdpa_decode` with
  ``q_start = cache_index`` and ``k_valid_len = cache_index + T``.  As in
  the reference this branch comes first, so it writes in the
  ``"append_free"`` mode too;
* ``"append_free"``, a scalar ``cache_index`` and T = 1: the token
  attends over the frozen cache ``[0, cache_index)`` and its own fresh
  K/V, the two pieces combined by their log-sum-exp
  (:func:`sdpa_two_piece`), and nothing is written.  With T > 1 the mode
  writes as ``"dus"`` does, as the reference's;
* ``"paged"``, a (B,) vector ``cache_index`` of per-slot write positions:
  the cache is a pair of page pools ``(P, ps, KV, hd)`` addressed through
  a (B, maxp) block table; the fresh rows are scattered to
  ``(table[b, pos // ps], pos % ps)`` and the queries attend through
  :func:`repro_torch.kernels.ops.paged_sdpa` with ``q_start =
  cache_index`` and ``k_valid_len = cache_index + T``.

Caches are updated in place — the port's caches are not copied each
step, which saves a whole-cache write per layer per token.

``causal=False`` drops the causal mask (the encoder's self-attention).
``kv_override`` is cross-attention (``attention.py:176-186, 264-277``):
K and V are projected from the source sequence (an encoder's output) on
every call, nothing is cached, no rope is applied, and the queries attend
over the whole source through ``ops.sdpa`` with the default ``q_pos0 = S
- Tq`` (a negative start when the queries outnumber the source), the
caller passing ``causal=False``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops

from .layers import Dense, RMSNorm, rope


_NEG_INF = -1e30


def sdpa_two_piece(q, k_cache, v_cache, k_new, v_new, *, window=None,
                   softcap=None, scale=None, q_position: int):
    """Single-token attention over (frozen cache, fresh token) combined by
    the streaming softmax's log-sum-exp, writing nothing — the reference's
    ``sdpa_two_piece`` (``attention.py:60-101``), plain PyTorch there and
    here.

    q: (B, 1, H, hd);  k_cache, v_cache: (B, S, KV, hd);  k_new, v_new:
    (B, 1, KV, hd).  The cache piece sees keys ``[0, q_position)``, and
    those past ``q_position - window`` with a window; it has no causal
    term, as the reference's.  The fresh piece is the token itself.  The
    cache rows past ``q_position`` meet zero probabilities, as in the
    reference (a NaN there would reach the output; real caches hold
    zeros)."""
    B, T, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    if scale is None:
        scale = hd ** -0.5
    qg = q.reshape(B, T, KV, G, hd).float()

    def piece(k, v, mask):
        logits = torch.einsum("btkgd,bskd->btkgs", qg, k.float()) * scale
        if softcap is not None:
            logits = softcap * torch.tanh(logits / softcap)
        logits = torch.where(mask, logits, _NEG_INF)
        m = logits.amax(dim=-1)
        p = torch.exp(logits - m[..., None])
        acc = torch.einsum("btkgs,bskd->btkgd", p, v.float())
        return acc, m, p.sum(dim=-1)

    kpos = torch.arange(S, device=q.device)
    mask_c = kpos < q_position
    if window is not None:
        mask_c = mask_c & (kpos > q_position - window)
    acc1, m1, l1 = piece(k_cache, v_cache, mask_c)
    acc2, m2, l2 = piece(k_new, v_new,
                         torch.ones(1, dtype=torch.bool, device=q.device))
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    out = (acc1 * a1[..., None] + acc2 * a2[..., None]) / \
        (l1 * a1 + l2 * a2).clamp_min(1e-30)[..., None]
    return out.reshape(B, T, H, hd).to(q.dtype)


class Attention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 *, dtype, device, qkv_bias: bool = False,
                 qk_norm: bool = False):
        super().__init__()
        self.n_heads, self.n_kv, self.head_dim = n_heads, n_kv, head_dim
        kw = dict(dtype=dtype, device=device)
        # qwen's QKV biases (``attn_init``, ``attention.py:142-147``); the
        # output projection has none
        self.wq = Dense(d_model, n_heads * head_dim, bias=qkv_bias, **kw)
        self.wk = Dense(d_model, n_kv * head_dim, bias=qkv_bias, **kw)
        self.wv = Dense(d_model, n_kv * head_dim, bias=qkv_bias, **kw)
        self.wo = Dense(n_heads * head_dim, d_model, **kw)
        self.q_norm = RMSNorm(head_dim, **kw) if qk_norm else None
        self.k_norm = RMSNorm(head_dim, **kw) if qk_norm else None

    def forward(self, x, *, rope_theta=10000.0, causal=True, window=None,
                softcap=None, scale=None, cache=None, cache_index=None,
                decode_mode="dus", block_table=None, kv_override=None):
        """Self-attention, causal unless ``causal=False``.  x: (B, T, D).
        With ``cache`` (dict k/v (B, S, KV, hd)) writes the fresh K/V at
        ``cache_index`` (an int, or a (B,) tensor of per-request positions;
        in place) and attends over the cache, or with
        ``decode_mode="append_free"``, an int index and T = 1, attends
        without writing; with ``decode_mode="paged"`` the cache is a pair
        of page pools (P, ps, KV, hd), ``cache_index`` a (B,) tensor and
        ``block_table`` (B, maxp) int32.  With ``kv_override`` (B, S_src,
        D) it is cross-attention over that source, uncached.  See the
        module docstring.  ``rope_theta=None`` applies no rope.  Returns y
        (B, T, D)."""
        if decode_mode == "paged":
            if kv_override is not None:
                raise NotImplementedError(
                    "paged decode does not support cross-attention K/V")
            return self._paged(x, rope_theta=rope_theta, causal=causal,
                               window=window, softcap=softcap, scale=scale,
                               cache=cache, cache_index=cache_index,
                               block_table=block_table)
        if decode_mode not in ("dus", "append_free"):
            raise NotImplementedError(
                f"decode_mode {decode_mode!r} is not ported to repro_torch "
                f"yet; see ROADMAP.md")
        if kv_override is not None:
            if cache is not None:
                raise ValueError("cross-attention takes no cache: its K/V "
                                 "are projected from the source each call")
            return self._cross(x, kv_override, causal=causal, window=window,
                               softcap=softcap, scale=scale)
        kw = dict(rope_theta=rope_theta, causal=causal, window=window,
                  softcap=softcap, scale=scale, cache=cache)
        if isinstance(cache_index, torch.Tensor):
            if cache is None or cache_index.ndim != 1:
                raise ValueError(
                    f"a tensor cache_index must be a (B,) vector of "
                    f"per-request positions over a cache, got shape "
                    f"{tuple(cache_index.shape)}")
            return self._dense_ragged(x, cache_index=cache_index, **kw)
        B, T, _ = x.shape
        if cache is not None and decode_mode == "append_free" and T == 1:
            return self._append_free(x, cache_index=cache_index, **kw)
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
            out = ops.sdpa(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale, q_pos0=pos0,
                           k_valid_len=pos0 + T)
        else:
            out = ops.sdpa(q, xk, xv, causal=causal, window=window,
                           softcap=softcap, scale=scale, q_pos0=0)
        return self.wo(out.reshape(B, T, self.n_heads * self.head_dim))

    def _qkv(self, x, positions, rope_theta, src=None):
        """q from ``x``; k, v from ``src`` (default ``x``).  Rope at
        ``positions`` unless ``rope_theta`` is None."""
        B, T, _ = x.shape
        src = x if src is None else src
        H, KV, hd = self.n_heads, self.n_kv, self.head_dim
        # the projections add their biases, then the QK-norm, then rope,
        # in the reference's order (``attention.py:175-197``)
        q = self.wq(x).reshape(B, T, H, hd)
        xk = self.wk(src).reshape(B, src.shape[1], KV, hd)
        xv = self.wv(src).reshape(B, src.shape[1], KV, hd)
        if self.q_norm is not None:
            q = self.q_norm(q)
            xk = self.k_norm(xk)
        if rope_theta is None:
            return q, xk, xv
        return rope(q, positions, rope_theta), rope(xk, positions,
                                                    rope_theta), xv

    def _cross(self, x, src, *, causal, window, softcap, scale):
        """Cross-attention over ``src`` (B, S_src, D): K/V projected from
        it, no rope, no cache, queries at the default ``S_src - T``."""
        B, T, _ = x.shape
        q, xk, xv = self._qkv(x, None, None, src=src)
        out = ops.sdpa(q, xk, xv, causal=causal, window=window,
                       softcap=softcap, scale=scale)
        return self.wo(out.reshape(B, T, self.n_heads * self.head_dim))

    def _dense_ragged(self, x, *, rope_theta, causal, window, softcap, scale,
                      cache, cache_index):
        """A (B,) ``cache_index`` over a dense cache
        (``attention.py:225-243``): scatter request b's fresh K/V to
        positions ``cache_index[b] + [0, T)``, in place, then attend
        through ``ops.sdpa_decode``.  The caller keeps every window inside
        the cache (the engine sizes it with ``speculate_k`` rows of
        headroom)."""
        B, T, _ = x.shape
        idx = cache_index.to(x.device)
        if idx.shape != (B,):
            raise ValueError(f"cache_index must be ({B},), got "
                             f"{tuple(idx.shape)}")
        pos = idx.long()[:, None] + torch.arange(T, device=x.device)
        q, xk, xv = self._qkv(x, pos, rope_theta)
        k, v = cache["k"], cache["v"]
        rows = torch.arange(B, device=x.device)[:, None]
        k[rows, pos] = xk.to(k.dtype)
        v[rows, pos] = xv.to(v.dtype)
        out = ops.sdpa_decode(q, k, v, q_start=idx, k_valid_len=idx + T,
                              causal=causal, window=window, softcap=softcap,
                              scale=scale)
        return self.wo(out.reshape(B, T, self.n_heads * self.head_dim))

    def _append_free(self, x, *, rope_theta, causal, window, softcap, scale,
                     cache, cache_index):
        """The append-free step (``attention.py:244-259``): one token at
        the int ``cache_index`` attends over the frozen cache ``[0,
        cache_index)`` and its own fresh K/V, and writes nothing.  The
        cache piece has no causal term, as the reference's, so ``causal``
        changes nothing here."""
        B, T, _ = x.shape
        q, xk, xv = self._qkv(
            x, cache_index + torch.arange(T, device=x.device), rope_theta)
        out = sdpa_two_piece(q, cache["k"], cache["v"], xk, xv,
                             window=window, softcap=softcap, scale=scale,
                             q_position=cache_index)
        return self.wo(out.reshape(B, T, self.n_heads * self.head_dim))

    def _paged(self, x, *, rope_theta, causal, window, softcap, scale, cache,
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
                             k_valid_len=idx + T, causal=causal,
                             window=window, softcap=softcap, scale=scale)
        return self.wo(out.reshape(B, T, self.n_heads * self.head_dim))
