"""DeepSeek-V3 Multi-head Latent Attention (port of ``repro/models/mla.py``,
arXiv:2412.19437).

Queries come through a low-rank bottleneck (``q_lora_rank``); keys and
values through a shared compressed latent (``kv_lora_rank``) plus one
decoupled RoPE key of ``qk_rope_dim`` shared by every head.  The cache
holds only the latent and the rope key, ``{"ckv": (B, S, kv_lora),
"krope": (B, S, rope)}``, and each call expands it to per-head K/V, as
the reference does (``mla.py:88-108``), then attends through
:mod:`repro_torch.kernels.ops` with the explicit scale ``qk_dim ** -0.5``
(full width: D = 192, Dv = 128).

The branches of ``mla_apply`` (``mla.py:42-110``):

* no cache (training): :func:`~repro_torch.kernels.ops.sdpa`, the flash
  kernel's forward with the plain version's backward on the card;
* a dense cache at an int ``cache_index``: the fresh latent rows written
  at ``cache_index``, in place, then ``ops.sdpa`` over the whole cache
  with ``k_valid_len = cache_index + T``;
* a (B,) ``cache_index`` (the fixed-batch speculative engine's drafts
  and verify window): request b's rows written at ``cache_index[b] +
  [0, T)``, then :func:`~repro_torch.kernels.ops.sdpa_decode` at those
  per-request positions.

The reference threads no decode mode into MLA: ``"append_free"`` writes
as ``"dus"``, and the paged cache raises where it is built, there
(``blocks.py:238-245``) and here (``blocks.stack_paged_cache_init``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.common import MLAConfig
from repro_torch.kernels import ops

from .layers import Dense, RMSNorm, rope


class MLA(nn.Module):
    """``mla_init`` / ``mla_apply``; parameter names are the reference's
    leaves (``wq_a``, ``q_a_norm``, ``wq_b``, ``wkv_a``, ``kv_a_norm``,
    ``wkv_b``, ``wo``)."""

    def __init__(self, d_model: int, n_heads: int, m: MLAConfig, *, dtype,
                 device):
        super().__init__()
        self.n_heads, self.m = n_heads, m
        kw = dict(dtype=dtype, device=device)
        qk = m.qk_nope_dim + m.qk_rope_dim
        self.wq_a = Dense(d_model, m.q_lora_rank, **kw)
        self.q_a_norm = RMSNorm(m.q_lora_rank, **kw)
        self.wq_b = Dense(m.q_lora_rank, n_heads * qk, **kw)
        self.wkv_a = Dense(d_model, m.kv_lora_rank + m.qk_rope_dim, **kw)
        self.kv_a_norm = RMSNorm(m.kv_lora_rank, **kw)
        self.wkv_b = Dense(m.kv_lora_rank,
                           n_heads * (m.qk_nope_dim + m.v_head_dim), **kw)
        self.wo = Dense(n_heads * m.v_head_dim, d_model, **kw)

    def forward(self, x, *, rope_theta=10000.0, softcap=None, cache=None,
                cache_index=None):
        """x: (B, T, D) -> (B, T, D).  ``cache`` (``{"ckv", "krope"}``) is
        updated in place at ``cache_index`` (an int, or a (B,) tensor of
        per-request positions)."""
        m, H = self.m, self.n_heads
        B, T, _ = x.shape
        nope, rd, r = m.qk_nope_dim, m.qk_rope_dim, m.kv_lora_rank
        scale = (nope + rd) ** -0.5

        q = self.wq_b(self.q_a_norm(self.wq_a(x))).reshape(B, T, H, nope + rd)
        kv_a = self.wkv_a(x)
        ckv = self.kv_a_norm(kv_a[..., :r])                    # (B, T, r)
        k_rope = kv_a[..., r:].reshape(B, T, 1, rd)
        ragged = isinstance(cache_index, torch.Tensor)
        if ragged:
            if cache is None or cache_index.shape != (B,):
                raise ValueError(
                    f"a tensor cache_index must be a ({B},) vector of "
                    f"per-request positions over a cache, got shape "
                    f"{tuple(cache_index.shape)}")
            idx = cache_index.to(x.device)
            positions = idx.long()[:, None] + torch.arange(T,
                                                           device=x.device)
        else:
            pos0 = 0 if cache_index is None else cache_index
            positions = pos0 + torch.arange(T, device=x.device)
        q = torch.cat([q[..., :nope], rope(q[..., nope:], positions,
                                           rope_theta)], dim=-1)
        k_rope = rope(k_rope, positions, rope_theta).reshape(B, T, rd)
        if cache is not None:
            c, kr = cache["ckv"], cache["krope"]
            if ragged:
                rows = torch.arange(B, device=x.device)[:, None]
                c[rows, positions] = ckv.to(c.dtype)
                kr[rows, positions] = k_rope.to(kr.dtype)
            else:
                if pos0 + T > c.shape[1]:
                    raise ValueError(f"cache of {c.shape[1]} positions "
                                     f"cannot hold positions "
                                     f"[{pos0}, {pos0 + T})")
                c[:, pos0:pos0 + T] = ckv
                kr[:, pos0:pos0 + T] = k_rope
            ckv, k_rope = c, kr
        S = ckv.shape[1]
        # the latent expanded to per-head K/V on every call
        kv = self.wkv_b(ckv).reshape(B, S, H, nope + m.v_head_dim)
        k = torch.cat([kv[..., :nope],
                       k_rope[:, :, None, :].expand(B, S, H, rd)], dim=-1)
        v = kv[..., nope:]
        if ragged:
            out = ops.sdpa_decode(q, k, v, q_start=idx, k_valid_len=idx + T,
                                  softcap=softcap, scale=scale)
        elif cache is not None:
            out = ops.sdpa(q, k, v, softcap=softcap, scale=scale,
                           q_pos0=pos0, k_valid_len=pos0 + T)
        else:
            out = ops.sdpa(q, k, v, softcap=softcap, scale=scale, q_pos0=0)
        return self.wo(out.reshape(B, T, H * m.v_head_dim))
