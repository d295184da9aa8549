"""Kernel entry points, dispatched by the device of the tensors.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the kernel's plain PyTorch version in :mod:`.ref`.
There is no configuration object and no fallback between the two: the
reference's ``KernelConfig(auto)`` and Pallas' ``interpret`` flag have no
counterpart here.  Launches are counted on the kernel wrapper
(``flash_attention.flash_attention_fwd.launches``).
"""
from __future__ import annotations

from . import ref
from .flash_attention import flash_attention_fwd


def sdpa(q, k, v, *, causal: bool = True, window=None, softcap=None,
         scale=None, q_pos0=None, k_valid_len=None):
    """Grouped-query attention in the model stack's layout — the entry
    point ``models.attention`` sends prefill and decode attention through
    (the reference's ``ops.sdpa``, ``ops.py:295``).

    q: (B, Tq, H, hd);  k, v: (B, S, KV, hd[, hd_v]) with H % KV == 0.
    Query i sits at absolute position ``q_pos0 + i`` (default ``S - Tq``;
    an int or a (B,) tensor); ``k_valid_len`` (int or (B,)) is the valid
    cache prefix (default ``S``)."""
    if q.device.type == "cuda":
        return flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale,
                                   q_start=q_pos0, k_valid_len=k_valid_len)
    if q.device.type == "cpu":
        return ref.grouped_sdpa_ref(q, k, v, causal=causal, window=window,
                                    softcap=softcap, scale=scale,
                                    q_pos0=q_pos0, k_valid_len=k_valid_len)
    raise NotImplementedError(f"no attention kernel for device {q.device}")


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    softcap=None, scale=None, q_start=None,
                    k_valid_len=None):
    """(B, H, Tq, D) x (B, KV, Tk, D) x (B, KV, Tk, Dv) -> (B, H, Tq, Dv),
    the reference's ``flash_attention_pallas`` layout.  The kernel reads
    these tensors through transposed views (no copies)."""
    out = sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
               causal=causal, window=window, softcap=softcap, scale=scale,
               q_pos0=q_start, k_valid_len=k_valid_len)
    return out.transpose(1, 2)
