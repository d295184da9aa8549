"""Attention: GQA/MQA with RoPE, sliding window, softcap, QK-norm and a
dense KV cache (port of ``repro/models/attention.py``).

:class:`Attention` is the reference's ``attn_init`` / ``attn_apply``.
It covers the no-cache path and the scalar-index ``"dus"`` cache path:
the fresh K/V rows are written into the preallocated cache at
``cache_index`` and the queries attend over the whole cache with
``k_valid_len = cache_index + T`` masking the empty tail.  The cache is
updated in place — the port's caches are not copied each step, which
saves a whole-cache write per layer per token.  Attention goes through
:func:`repro_torch.kernels.ops.sdpa` (the CUDA kernel on the card).

The reference's per-slot vector ``cache_index`` is not ported yet and
raises, as do its ``"append_free"`` and ``"paged"`` decode modes
(``model.decode_step``).
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
                scale=None, cache=None, cache_index=None):
        """Causal self-attention.  x: (B, T, D).  With ``cache`` (dict k/v
        (B, S, KV, hd)) writes the fresh K/V at the int ``cache_index``
        (in place) and attends over the cache.  Returns y (B, T, D)."""
        if cache_index is not None and not isinstance(cache_index, int):
            raise NotImplementedError(
                "per-slot vector cache_index is not ported yet; pass an int")
        B, T, _ = x.shape
        H, KV, hd = self.n_heads, self.n_kv, self.head_dim
        q = self.wq(x).reshape(B, T, H, hd)
        xk = self.wk(x).reshape(B, T, KV, hd)
        xv = self.wv(x).reshape(B, T, KV, hd)
        if self.q_norm is not None:        # QK-norm runs before rope
            q = self.q_norm(q)
            xk = self.k_norm(xk)
        pos0 = 0 if cache_index is None else cache_index
        positions = pos0 + torch.arange(T, device=x.device)
        q = rope(q, positions, rope_theta)
        xk = rope(xk, positions, rope_theta)
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
        return self.wo(out.reshape(B, T, H * hd))
