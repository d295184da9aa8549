"""Kernel entry points, dispatched by the device of the tensors.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the kernel's plain PyTorch version in :mod:`.ref`.
The attention entry points (:func:`sdpa`, :func:`sdpa_decode`), the
gossip combine (:func:`gossip_mix_many`) and the fused DSGD step
(:func:`fused_dsgd_steps`) also take ``meta`` tensors, for the dry run
(``launch.dryrun``): they return empty outputs of the right shapes and
dtypes and compute nothing (attention with a backward of the same
kind), a shape function, not a third version.
There is no configuration object and no fallback between the two: the
reference's ``KernelConfig(auto)`` and Pallas' ``interpret`` flag have no
counterpart here.  Launches are counted on the kernel wrappers
(``flash_attention.flash_attention_fwd.launches``,
``paged_flash_attention.paged_flash_attention_fwd.launches``,
``fused_dsgd.fused_dsgd.launches``,
``fused_dsgd.fused_dsgd_many.launches``,
``quantized_gossip.quantize_ef.launches``,
``quantized_gossip.quantize_ef_many.launches``,
``gossip_mix.gossip_mix_slots.launches``,
``gossip_mix.gossip_mix_slots_many.launches``,
``gossip_mix.gossip_mix_stacked.launches``,
``quantized_gossip.quantized_gossip_mix.launches``,
``quantized_gossip.quantized_gossip_mix_many.launches``); the grouped
entry points (``*_many``, and the quantized kernels' one-tensor calls)
also count the tensors their launches covered, in ``segments``.  The
grouped entry points (``fused_dsgd_steps``, ``gossip_mix_many``,
``quantize_payload_many``, ``quantized_gossip_mix_many``) take a list of
tensors: on the card one launch per table of segments (and per dtype or
mode), on the CPU the plain version tensor by tensor.
"""
from __future__ import annotations

import torch

from . import ref
from .flash_attention import flash_attention_fwd
from .fused_dsgd import fused_dsgd, fused_dsgd_many
from .gossip_mix import (gossip_mix_slots, gossip_mix_slots_many,
                         gossip_mix_stacked)
from .paged_flash_attention import paged_flash_attention_fwd
from .quantized_gossip import (quantize_ef, quantize_ef_many,
                               quantized_gossip_mix as _qmix,
                               quantized_gossip_mix_many as _qmix_many)


def _as_2d(a: torch.Tensor, *, lead_rows: bool = False):
    """Normalise an arbitrary-rank leaf to the (R, C) layout the fused
    kernels take (``ops.py:131-145``).  ``lead_rows=True`` keeps axis 0
    as the row axis (so a per-leading-axis scale vector maps onto rows);
    otherwise the last axis becomes columns and everything before it
    folds into rows.  Returns (view, original shape)."""
    shape = a.shape
    if a.ndim == 2 and not lead_rows:
        return a, shape
    if a.ndim == 0:
        return a.reshape(1, 1), shape
    if lead_rows:   # before the 1-D case: an (n,) leaf maps to (n, 1)
        return a.reshape(shape[0], -1), shape
    if a.ndim == 1:
        return a.reshape(1, -1), shape
    return a.reshape(-1, shape[-1]), shape


# ---------------------------------------------------------------------------
# gossip combine
# ---------------------------------------------------------------------------

def gossip_mix(bufs, weights):
    """Fused weighted combine ``sum_s weights[s] * bufs[s]`` (the
    reference's ``ops.gossip_mix``, ``ops.py:152-189``).

    ``bufs`` is a sequence of S equal-shape buffers (the distributed
    round's own buffer and each received one: the slots entry point) or
    a stacked ``(S, ...)`` tensor (the stacked entry point).  ``weights``
    is S floats.  The output has the slot shape and dtype."""
    if isinstance(bufs, (list, tuple)):
        slots = list(bufs)
        if not slots:
            raise ValueError("gossip_mix needs at least one buffer")
        dev = slots[0].device
        if dev.type == "cuda":
            two_d = [_as_2d(b) for b in slots]
            out = gossip_mix_slots([b for b, _ in two_d], weights)
            return out.reshape(two_d[0][1])
    else:
        dev = bufs.device
        if dev.type == "cuda":
            S, shape = bufs.shape[0], bufs.shape[1:]
            R, C = _as_2d(bufs[0])[0].shape
            return gossip_mix_stacked(bufs.reshape(S, R, C),
                                      weights).reshape(shape)
    if dev.type == "cpu":
        return ref.gossip_mix_ref(bufs, weights)
    raise NotImplementedError(f"no gossip-mix kernel for device {dev}")


def _one_device(tensors, what: str) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what} takes tensors on one device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    return dev


def gossip_mix_many(slot_lists, weights, out_dtype=None):
    """The combine of :func:`gossip_mix` for many tensors of one round:
    ``[sum_s weights[s] * bufs[s] for bufs in slot_lists]``.

    slot_lists: T sequences of S buffers each (slot 0 the node's own), one
    tensor's buffers of one shape, all on one device; weights: S floats.
    out_dtype: None (each tensor's buffers' dtype), a dtype, or one per
    tensor; the f32 sum is rounded to it once.  On the card it is one
    grouped kernel launch per (input, output) dtype pair."""
    lists = [list(b) for b in slot_lists]
    if not lists:
        return []
    if any(not b for b in lists):
        raise ValueError("gossip_mix_many needs at least one buffer per "
                         "tensor")
    dev = lists[0][0].device
    if dev.type == "cuda":      # the wrapper checks every buffer
        return gossip_mix_slots_many(lists, weights, out_dtype)
    if dev.type == "cpu":
        _one_device([b for bufs in lists for b in bufs], "gossip_mix_many")
        for bufs in lists:
            if any(b.shape != bufs[0].shape for b in bufs):
                raise ValueError(f"one tensor's slots must be one shape, "
                                 f"got {[tuple(b.shape) for b in bufs]}")
        if out_dtype is None or isinstance(out_dtype, torch.dtype):
            out_dtype = [out_dtype] * len(lists)
        return [ref.gossip_mix_ref(bufs, weights, out_dtype=d)
                for bufs, d in zip(lists, out_dtype, strict=True)]
    if dev.type == "meta":
        if out_dtype is None or isinstance(out_dtype, torch.dtype):
            out_dtype = [out_dtype] * len(lists)
        return [torch.empty_like(bufs[0], dtype=d or bufs[0].dtype)
                for bufs, d in zip(lists, out_dtype, strict=True)]
    raise NotImplementedError(f"no gossip-mix kernel for device {dev}")


def quantized_gossip_mix(own, q_slots, scale_slots, weights):
    """Fused dequantize-and-combine for one compressed gossip round:
    ``w[0]*own + sum_s w[s+1]*(q_s * scale_s)`` (the reference's
    ``ops.quantized_gossip_mix``, ``ops.py:222-242``).

    own: (R, C) f32; q_slots: S received (R, C) int8/fp8 payloads;
    scale_slots: S received (R, 1) f32 scales; weights: S + 1 floats,
    the self weight first.  Returns (R, C) f32."""
    if own.device.type == "cuda":
        return _qmix(own, q_slots, scale_slots, weights)
    if own.device.type == "cpu":
        return ref.quantized_gossip_mix_ref(own, list(q_slots),
                                            list(scale_slots), weights)
    raise NotImplementedError(f"no quantized gossip-mix kernel for device "
                              f"{own.device}")


def quantized_gossip_mix_many(owns, q_lists, scale_lists, weights):
    """:func:`quantized_gossip_mix` for many buffers of one round (the
    distributed mixer's bucket of reference leaves): ``[w[0]*own + sum_s
    w[s+1]*(q_s * scale_s) for each own]``.

    owns: (R_i, C_i) f32, all on one device; q_lists / scale_lists: per
    buffer its S received payloads and (R_i, 1) scales; weights: S + 1
    floats.  On the card it is one grouped kernel launch per table and
    payload dtype; on the CPU the plain version, buffer by buffer."""
    owns, q_lists, scale_lists = list(owns), list(q_lists), list(scale_lists)
    if not len(owns) == len(q_lists) == len(scale_lists):
        raise ValueError(f"{len(owns)} own buffers, {len(q_lists)} payload "
                         f"lists, {len(scale_lists)} scale lists")
    if not owns:
        return []
    dev = owns[0].device
    if dev.type == "cuda":      # the wrapper checks every buffer
        return _qmix_many(owns, q_lists, scale_lists, weights)
    if dev.type == "cpu":
        _one_device(owns + [t for ts in q_lists + scale_lists for t in ts],
                    "quantized_gossip_mix_many")
        return [ref.quantized_gossip_mix_ref(own, list(qs), list(scs),
                                             weights)
                for own, qs, scs in zip(owns, q_lists, scale_lists)]
    raise NotImplementedError(f"no quantized gossip-mix kernel for device "
                              f"{dev}")


# ---------------------------------------------------------------------------
# fused DSGD(-momentum) update
# ---------------------------------------------------------------------------

def fused_dsgd_step(x, u, g, beta, eta, pre_scale=1.0):
    """``u' = beta*u + g;  x' = pre_scale * (x - eta*u')`` in one pass
    (the reference's ``ops.fused_dsgd_step``, ``ops.py:249-270``).

    Accepts leaves of any rank.  ``pre_scale`` is a scalar, or a vector
    over the leaf's leading axis (the simulation engine folds the
    per-node gossip self-weight ``diag(W)`` through it — see
    ``repro_torch.optim.decentralized.DSGD``)."""
    per_row = isinstance(pre_scale, torch.Tensor) and pre_scale.ndim >= 1
    if x.device.type == "cuda":
        x2, shape = _as_2d(x, lead_rows=per_row)
        u2, _ = _as_2d(u, lead_rows=per_row)
        g2, _ = _as_2d(g, lead_rows=per_row)
        x_new, u_new = fused_dsgd(x2, u2, g2, beta, eta, pre_scale)
        return x_new.reshape(shape), u_new.reshape(shape)
    if x.device.type == "cpu":
        if per_row:
            pre_scale = pre_scale.reshape((-1,) + (1,) * (x.ndim - 1))
        return ref.fused_dsgd_ref(x, u, g, beta, eta, pre_scale)
    raise NotImplementedError(f"no fused DSGD kernel for device {x.device}")


def fused_dsgd_steps(xs, us, gs, beta, eta, pre_scale=1.0):
    """:func:`fused_dsgd_step` over lists of leaves: returns the lists
    ``(xs', us')``.  ``pre_scale`` is a scalar, or one vector over the
    leading (node) axis that every leaf shares.  On the card it is one
    grouped kernel launch per dtype present; on the CPU the plain
    version, leaf by leaf."""
    xs, us, gs = list(xs), list(us), list(gs)
    if not len(xs) == len(us) == len(gs):
        raise ValueError(f"{len(xs)} x, {len(us)} u, {len(gs)} g")
    if not xs:
        return [], []
    dev = xs[0].device
    if dev.type == "cuda":      # the wrapper checks every leaf
        return fused_dsgd_many(xs, us, gs, beta, eta, pre_scale)
    if dev.type == "cpu":
        _one_device(xs + us + gs, "fused_dsgd_steps")
        pairs = [fused_dsgd_step(x, u, g, beta, eta, pre_scale)
                 for x, u, g in zip(xs, us, gs)]
        return [x for x, _ in pairs], [u for _, u in pairs]
    if dev.type == "meta":
        return ([torch.empty_like(x) for x in xs],
                [torch.empty_like(u) for u in us])
    raise NotImplementedError(f"no fused DSGD kernel for device {dev}")


# ---------------------------------------------------------------------------
# quantized gossip payloads (repro_torch.compress)
# ---------------------------------------------------------------------------

QUANT_FORMATS = ("int8", "fp8")


def quantize_payload(x, err=None, *, fmt: str, key: int, row_offset=0):
    """One-pass payload quantization for compressed gossip: per-row amax
    scale, hash stochastic rounding and the EF21 residual (the
    reference's ``ops.quantize_payload``, ``ops.py:196-219``).

    x: (R, C) float32 in the chunk-row layout (C = the codec's chunk);
    ``err`` the carried residual (added to x before rounding) or None;
    ``key`` a uint32 int from :func:`repro_torch.kernels.ref.sr_key`;
    ``row_offset`` the global index of row 0.  Returns ``(q, scale,
    resid)``, see :func:`repro_torch.kernels.ref.quantize_ef_ref`.  On
    the card a shape the kernel does not take raises."""
    if fmt not in QUANT_FORMATS:
        raise ValueError(f"fmt must be one of {QUANT_FORMATS}, got {fmt!r}")
    if x.device.type == "cuda":
        return quantize_ef(x, err, key, row_offset, fmt=fmt)
    if x.device.type == "cpu":
        return ref.quantize_ef_ref(x, err, key, row_offset, fmt=fmt)
    raise NotImplementedError(f"no quantize kernel for device {x.device}")


def quantize_payload_many(xs, errs=None, *, fmt: str, key: int,
                          row_offsets):
    """:func:`quantize_payload` of many chunk-row buffers with one key
    (the compressed mixers' bucket of reference leaves).

    xs: (R_i, C_i) float32 buffers on one device; errs: None, or one per
    buffer (a tensor or None); row_offsets: the global index of each
    buffer's row 0.  Returns the lists ``(qs, scales, resids)``, each
    buffer's bits those of :func:`quantize_payload` on it alone.  On the
    card it is one grouped kernel launch per table and mode (with or
    without err); on the CPU the plain version, buffer by buffer."""
    if fmt not in QUANT_FORMATS:
        raise ValueError(f"fmt must be one of {QUANT_FORMATS}, got {fmt!r}")
    xs, row_offsets = list(xs), list(row_offsets)
    errs = [None] * len(xs) if errs is None else list(errs)
    if not len(xs) == len(errs) == len(row_offsets):
        raise ValueError(f"{len(xs)} x, {len(errs)} err, "
                         f"{len(row_offsets)} row offsets")
    if not xs:
        return [], [], []
    dev = xs[0].device
    if dev.type == "cuda":      # the wrapper checks every buffer
        return quantize_ef_many(xs, errs, key, row_offsets, fmt=fmt)
    if dev.type == "cpu":
        _one_device(xs + [e for e in errs if e is not None],
                    "quantize_payload_many")
        outs = [ref.quantize_ef_ref(x, e, key, off, fmt=fmt)
                for x, e, off in zip(xs, errs, row_offsets)]
        return ([q for q, _, _ in outs], [sc for _, sc, _ in outs],
                [r for _, _, r in outs])
    raise NotImplementedError(f"no quantize kernel for device {dev}")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

class _FlashSdpa(torch.autograd.Function):
    """The flash kernel's forward with the reference's backward
    (``ops.py:426-449``): the kernel has no backward, so the gradient
    recomputes the plain version under autograd from the saved q, k, v
    with the same positions and window."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, q_pos0,
                k_valid_len):
        ctx.save_for_backward(q, k, v)
        ctx.attrs = dict(causal=causal, window=window, softcap=softcap,
                         scale=scale, q_pos0=q_pos0,
                         k_valid_len=k_valid_len)
        return flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale,
                                   q_start=q_pos0, k_valid_len=k_valid_len)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = ref.grouped_sdpa_ref(q, k, v, **ctx.attrs)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v),
                                         grad_out.to(out.dtype))
        return dq, dk, dv, None, None, None, None, None, None


class _MetaSdpa(torch.autograd.Function):
    """Attention's shape on the ``meta`` device: an empty ``(B, Tq, H,
    hd_v)`` output in q's dtype, and empty gradients of q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.like = (q, k, v)
        return q.new_empty(q.shape[:-1] + v.shape[-1:])

    @staticmethod
    def backward(ctx, grad_out):
        return tuple(torch.empty_like(t) for t in ctx.like)


def _meta_attention(q, k, v):
    if q.shape[2] % k.shape[2] or k.device.type != "meta" \
            or v.device.type != "meta":
        raise ValueError(f"attention on meta takes meta q, k, v with H % KV "
                         f"== 0, got {tuple(q.shape)}, {tuple(k.shape)} on "
                         f"{k.device}")
    return _MetaSdpa.apply(q, k, v)


def sdpa(q, k, v, *, causal: bool = True, window=None, softcap=None,
         scale=None, q_pos0=None, k_valid_len=None):
    """Grouped-query attention in the model stack's layout — the entry
    point ``models.attention`` sends prefill, decode and training
    attention through (the reference's ``ops.sdpa``, ``ops.py:295``).

    q: (B, Tq, H, hd);  k, v: (B, S, KV, hd[, hd_v]) with H % KV == 0.
    Query i sits at absolute position ``q_pos0 + i`` (default ``S - Tq``;
    an int or a (B,) tensor); ``k_valid_len`` (int or (B,)) is the valid
    cache prefix (default ``S``).  On the card it is differentiable: the
    forward is the kernel and the backward the plain version's."""
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _FlashSdpa.apply(q, k, v, causal, window, softcap, scale,
                                    q_pos0, k_valid_len)
        return flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale,
                                   q_start=q_pos0, k_valid_len=k_valid_len)
    if q.device.type == "cpu":
        return ref.grouped_sdpa_ref(q, k, v, causal=causal, window=window,
                                    softcap=softcap, scale=scale,
                                    q_pos0=q_pos0, k_valid_len=k_valid_len)
    if q.device.type == "meta":
        return _meta_attention(q, k, v)
    raise NotImplementedError(f"no attention kernel for device {q.device}")


def sdpa_decode(q, k, v, *, q_start, k_valid_len, causal: bool = True,
                window=None, softcap=None, scale=None):
    """Dense-cache decode / verify attention with per-request query
    positions — the entry point ``models.attention`` sends the fixed-batch
    speculative engine's draft steps and its (k+1)-row verify through (the
    reference's ``ops.sdpa_decode``, ``ops.py:340``).

    q: (B, Tq, H, hd);  k, v: (B, S, KV, hd[, hd_v]) with H % KV == 0;
    q_start / k_valid_len: ints or (B,) tensors, per request (after the
    first round every request sits at its own position).  Serving only:
    the reference has no gradient here, and an input that requires one
    raises.  A row's result does not depend on Tq, on the card (the
    kernel's row contract) and on the CPU (the plain version computes row
    by row)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("sdpa_decode has no gradient (the reference's "
                           "is VJP-free); call it under no_grad or "
                           "inference_mode")
    kw = dict(q_start=q_start, k_valid_len=k_valid_len, causal=causal,
              window=window, softcap=softcap, scale=scale)
    if q.device.type == "cuda":
        return flash_attention_fwd(q, k, v, **kw)
    if q.device.type == "cpu":
        return ref.grouped_sdpa_decode_ref(q, k, v, **kw)
    if q.device.type == "meta":
        return _meta_attention(q, k, v)
    raise NotImplementedError(f"no attention kernel for device {q.device}")


def paged_sdpa(q, k_pages, v_pages, block_table, *, q_start, k_valid_len,
               causal: bool = True, window=None, softcap=None, scale=None):
    """Attention over a paged KV cache in the model stack's layout — the
    entry point ``models.attention`` sends paged decode and speculative
    verify through (the reference's ``ops.paged_sdpa``, ``ops.py:376``).

    q: (B, Tq, H, hd);  k_pages, v_pages: (P, ps, KV, hd[, hd_v]) with
    H % KV == 0;  block_table: (B, maxp) int32 (slot b's positions
    ``[j*ps, (j+1)*ps)`` live at page ``block_table[b, j]``);  q_start /
    k_valid_len: ints or (B,) tensors, per slot.  Serving only: no
    gradient, as in the reference.  A row's result does not depend on Tq,
    on the card (the kernel's row contract) and on the CPU."""
    kw = dict(q_start=q_start, k_valid_len=k_valid_len, causal=causal,
              window=window, softcap=softcap, scale=scale)
    if q.device.type == "cuda":
        return paged_flash_attention_fwd(q, k_pages, v_pages, block_table,
                                         **kw)
    if q.device.type == "cpu":
        return ref.paged_sdpa_ref(q, k_pages, v_pages, block_table, **kw)
    raise NotImplementedError(f"no paged attention kernel for device "
                              f"{q.device}")


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
