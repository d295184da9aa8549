"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

Each is the port of the matching oracle in ``repro/kernels/ref.py`` and
computes what its CUDA kernel computes.  ``ops`` sends CPU tensors here;
``chip_smoke.py`` holds each kernel against its plain version on the
card.  They repeat the kernels' arithmetic in f32 and are no yardstick
of speed.
"""
from __future__ import annotations

import torch

_NEG_INF = -1e30


def fused_dsgd_ref(x, u, g, beta: float, eta: float, pre_scale=1.0):
    """Fused heavy-ball momentum + SGD step, with the gossip self-weight
    pre-scale (``ref.py:29-46``), the plain version of the fused DSGD
    kernel:

        u' = beta * u + g
        x' = pre_scale * (x - eta * u')

    in f32, cast back to x's and u's dtypes.  ``pre_scale`` is a scalar
    or a tensor broadcastable against ``x`` (per-node self-weights arrive
    shaped ``(n, 1, ..., 1)``).  Each line is one PyTorch op, so nothing
    fuses into an FMA, and the kernel's rounding steps are these."""
    xf, uf, gf = x.float(), u.float(), g.float()
    if isinstance(pre_scale, torch.Tensor):
        pre_scale = pre_scale.float()
    u_new = beta * uf + gf
    x_new = pre_scale * (xf - eta * u_new)
    return x_new.to(x.dtype), u_new.to(u.dtype)


def _f32_weights(weights) -> list[float]:
    """Mixing weights as Python floats holding f32 values: the products
    below are f32 (PyTorch rounds a Python scalar to the f32 tensor's
    type), as the reference's ``jnp.asarray(weights, f32)`` makes them."""
    if isinstance(weights, torch.Tensor):
        weights = weights.detach().to("cpu", torch.float64).tolist()
    return [float(torch.tensor(float(w), dtype=torch.float32))
            for w in weights]


def gossip_mix_ref(bufs, weights, out_dtype=None):
    """Weighted combine of the node's own buffer and the buffers it
    received (``ref.py:16-26``), the plain version of the gossip-mix
    kernel:

        out = sum_s weights[s] * bufs[s]

    accumulated in f32 in slot order (``acc = w0*b0``, then ``acc = acc +
    ws*bs``, one rounding per product and per sum), cast once to
    ``out_dtype`` (default: the buffers' dtype).  ``bufs`` is a stacked
    ``(S, ...)`` tensor or a sequence of S equal-shape tensors;
    ``weights`` S floats."""
    slots = list(bufs.unbind(0)) if isinstance(bufs, torch.Tensor) \
        else list(bufs)
    w = _f32_weights(weights)
    if len(w) != len(slots) or not slots:
        raise ValueError(f"{len(slots)} buffers, {len(w)} weights")
    acc = w[0] * slots[0].float()
    for ws, b in zip(w[1:], slots[1:]):
        acc = acc + ws * b.float()
    return acc.to(out_dtype or slots[0].dtype)


def quantized_gossip_mix_ref(own, q_slots, scale_slots, weights):
    """Dequantize-and-combine for one compressed gossip round
    (``ref.py:369-386``), the plain version of the quantized gossip-mix
    kernel:

        out = w[0] * own + sum_s w[s+1] * (q_s * scale_s)

    own: (R, C) f32, the node's own exact values; q_slots: S received
    (R, C) int8 / float8_e4m3fn payloads; scale_slots: S (R, 1) f32;
    weights: S + 1 floats, the self weight first.  f32, in that order,
    one rounding per product and per sum."""
    w = _f32_weights(weights)
    if len(w) != len(q_slots) + 1 or len(q_slots) != len(scale_slots):
        raise ValueError(f"{len(q_slots)} payloads, {len(scale_slots)} "
                         f"scales, {len(w)} weights")
    acc = w[0] * own.to(torch.float32)
    for ws, q, sc in zip(w[1:], q_slots, scale_slots):
        acc = acc + ws * (q.to(torch.float32) * sc.to(torch.float32))
    return acc


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None,
                        softcap=None, scale=None):
    """Plain-softmax attention oracle (``ref.py:49-78``).

    q: (B, H, Tq, D);  k, v: (B, H, Tk, D) — callers handling GQA
    broadcast the kv heads first.  Key j attends to query i iff
    ``i - window < j <= i`` (when causal), the last query aligned to the
    last key; fully masked rows give zeros."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qi = torch.arange(Tq, device=q.device)[:, None] + (Tk - Tq)
    kj = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(logits - m)
    p = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def grouped_sdpa_ref(q, k, v, *, causal: bool = True, window=None,
                     softcap=None, scale=None, q_pos0=None,
                     k_valid_len=None):
    """Grouped-query attention in the model stack's layout — the plain
    version of the flash-attention kernel (``ref.py:81-141``).

    q: (B, Tq, H, hd);  k, v: (B, S, KV, hd[, hd_v]) with H % KV == 0;
    query head h reads kv head h // (H // KV).  Query i sits at absolute
    position ``q_pos0 + i`` (default ``S - Tq``; a scalar, or a (B,)
    tensor of per-batch starts).  ``k_valid_len`` (int or (B,)) is the
    valid cache prefix.  Value rows at or past it are zeroed before the
    accumulate, as the kernel does, so garbage in the cache tail never
    reaches the output.  Masked logits are -1e30 (not -inf) and the
    denominator is clamped at 1e-30, as in the reference.
    """
    B, Tq, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    G = H // KV
    dev = q.device
    if scale is None:
        scale = hd ** -0.5
    if q_pos0 is None:
        q_pos0 = S - Tq
    q_pos0 = torch.as_tensor(q_pos0, device=dev).reshape(-1, 1)   # (1|B, 1)
    qpos = q_pos0 + torch.arange(Tq, device=dev)                  # (1|B, Tq)
    kpos = torch.arange(S, device=dev)
    m = torch.ones((qpos.shape[0], Tq, S), dtype=torch.bool, device=dev)
    if causal:
        m &= kpos[None, None, :] <= qpos[:, :, None]
    if window is not None:
        m &= kpos[None, None, :] > qpos[:, :, None] - window
    kf, vf = k.float(), v.float()
    if k_valid_len is not None:
        valid = kpos[None, :] < torch.as_tensor(
            k_valid_len, device=dev).reshape(-1, 1)               # (1|B, S)
        m = m & valid[:, None, :]
        keep = valid[:, :, None, None]
        kf = torch.where(keep, kf, 0.0)
        vf = torch.where(keep, vf, 0.0)
    qg = q.float().reshape(B, Tq, KV, G, hd)
    logits = torch.einsum("btkgd,bskd->btkgs", qg, kf) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(m[:, :, None, None, :], logits, _NEG_INF)
    mx = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - mx)
    out = torch.einsum("btkgs,bskd->btkgd", p, vf)
    den = p.sum(dim=-1).clamp_min(1e-30)
    out = out / den[..., None]
    return out.reshape(B, Tq, H, hd_v).to(q.dtype)


def paged_sdpa_ref(q, k_pages, v_pages, block_table, *, q_start,
                   k_valid_len, causal: bool = True, window=None,
                   softcap=None, scale=None):
    """Paged-cache attention in the model stack's layout — the plain
    version of the paged flash-attention kernel (``ref.py:203-255``).

    q: (B, Tq, H, hd);  k_pages: (P, ps, KV, hd);  v_pages: (P, ps, KV,
    hd_v);  block_table: (B, maxp) — slot b's positions ``[j*ps,
    (j+1)*ps)`` live at page ``block_table[b, j]``.  ``q_start`` and
    ``k_valid_len`` are ints or (B,) tensors: query i of slot b sits at
    ``q_start[b] + i``.

    The pages are gathered into the dense view (indexing), then
    :func:`grouped_sdpa_decode_ref` runs each query row as a Tq = 1 call
    of :func:`grouped_sdpa_ref`.  So against a dense cache holding the
    same bits the result is :func:`grouped_sdpa_ref`'s, row by row, bit
    for bit; and a row's result does not depend on Tq (a (k+1)-row verify
    window equals k+1 one-row calls bit for bit)."""
    B = q.shape[0]
    _, ps, KV, hd = k_pages.shape
    hd_v = v_pages.shape[-1]
    S = block_table.shape[1] * ps
    tbl = block_table.long()
    k = k_pages[tbl].reshape(B, S, KV, hd)
    v = v_pages[tbl].reshape(B, S, KV, hd_v)
    return grouped_sdpa_decode_ref(q, k, v, q_start=q_start,
                                   k_valid_len=k_valid_len, causal=causal,
                                   window=window, softcap=softcap,
                                   scale=scale)


def grouped_sdpa_decode_ref(q, k, v, *, q_start, k_valid_len,
                            causal: bool = True, window=None, softcap=None,
                            scale=None):
    """Dense-cache decode / verify attention with per-request query
    positions — the plain version of ``ops.sdpa_decode`` (``ref.py:144``).

    q: (B, Tq, H, hd);  k, v: (B, S, KV, hd[, hd_v]) with H % KV == 0;
    ``q_start`` and ``k_valid_len`` are ints or (B,) tensors: query i of
    request b sits at ``q_start[b] + i`` and sees the cache prefix
    ``[0, k_valid_len[b])``.  Each query row runs :func:`grouped_sdpa_ref`
    as a Tq = 1 call, so a (k+1)-row verify window equals k+1 one-row
    calls bit for bit, which one product over all rows would not promise
    on the CPU: the reference scans rows for the same reason.  Value rows
    at or past ``k_valid_len`` are zeroed, as the kernel does (the
    reference multiplies them by zero probabilities instead, so a NaN
    there reaches its output)."""
    Tq = q.shape[1]
    q_start = torch.as_tensor(q_start, device=q.device).reshape(-1)
    k_valid = torch.as_tensor(k_valid_len, device=q.device).reshape(-1)
    return torch.cat([grouped_sdpa_ref(
        q[:, i:i + 1], k, v, causal=causal, window=window, softcap=softcap,
        scale=scale, q_pos0=q_start + i, k_valid_len=k_valid)
        for i in range(Tq)], dim=1)


# ---------------------------------------------------------------------------
# quantized gossip payloads (repro_torch.compress)
#
# The stochastic-rounding noise is a deterministic hash of (key, global
# element index), as in the reference (``ref.py:273-366``): a node's rows
# quantized alone (row_offset = node * rows_per_node) get the same bits as
# the node-stacked array.  torch has no uint32 arithmetic, so the hash
# runs on int64 tensors that hold values in [0, 2^32); every product is
# split so that it stays below 2^63 (signed overflow is never relied on).
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
# the largest magnitude each format's per-row scale maps amax to, and its
# reciprocal rounded to f32: the scale is ``amax * float32(1/QMAX)``, an
# explicit multiply, never a division (``ref.py:277-288``)
_SR_QMAX = {"int8": 127.0, "fp8": 448.0}
_SR_INV_QMAX = {k: float(torch.tensor(1.0 / q, dtype=torch.float32))
                for k, q in _SR_QMAX.items()}


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``(a * b) mod 2^32`` for an int64 tensor ``a`` in [0, 2^32) and an
    int ``b`` in [0, 2^32), exactly: b is split into 16-bit halves, so no
    partial product reaches 2^48."""
    lo = a * (b & 0xFFFF)
    hi = a * (b >> 16)
    hi &= 0xFFFF
    hi <<= 16
    lo += hi
    lo &= _MASK32
    return lo


def sr_key(seed, t) -> int:
    """Fold (codec seed, step counter) into one uint32 hash key, on the
    host (``ref.py:292-300``); the ``| 1`` keeps it nonzero.  ``seed``
    and ``t`` are ints (reduced mod 2^32, as the reference's uint32 casts
    do)."""
    s, tt = int(seed) & _MASK32, int(t) & _MASK32
    return (((s * 0x9E3779B1) & _MASK32) ^ ((tt * 0x85EBCA77) & _MASK32)) | 1


def _sr_bits(key: int, idx: torch.Tensor) -> torch.Tensor:
    """murmur3-finalizer uint32 hash of an element-index grid
    (``ref.py:303-312``).  ``idx`` is int64 in [0, 2^32); so is the
    result."""
    h = _mul32(idx, 0x9E3779B1)
    h ^= int(key) & _MASK32
    h ^= h >> 16
    h = _mul32(h, 0x85EBCA6B)
    h ^= h >> 13
    h = _mul32(h, 0xC2B2AE35)
    h ^= h >> 16
    return h


def element_index(R: int, C: int, row_offset, device) -> torch.Tensor:
    """The (R, C) int64 grid ``((row + row_offset) * C + col) mod 2^32``:
    what the reference's int32 ``(rows + row_offset) * C + cols`` gives
    once cast to uint32 (``ref.py:357-360``)."""
    rows = (torch.arange(R, dtype=torch.int64, device=device)
            + int(row_offset)) & _MASK32
    base = _mul32(rows, C & _MASK32)
    idx = base[:, None] + torch.arange(C, dtype=torch.int64, device=device)
    idx &= _MASK32
    return idx


def _quantize_core(s, scale, bits, fmt: str):
    """The payload math of ``ref.py:315-343``: returns ``(q, hat)``, with
    ``hat = q * scale`` the dequantized f32 value.

    * int8: ``floor(v + u)`` with ``u = float32(bits) * 2^-32`` (which can
      round up to exactly 1.0), clipped to +-127;
    * fp8 (e4m3fn): 20 hash bits injected below the 3-bit target mantissa
      and truncated, clipped to +-448, then cast, which rounds to nearest
      even on e4m3's subnormal tail.

    Each f32 line is one PyTorch op, so nothing contracts into an FMA."""
    v = s / scale
    if fmt == "int8":
        u = bits.to(torch.float32)
        u *= 2.0 ** -32
        v += u
        del u
        v.floor_()
        v.clamp_(-127.0, 127.0)
        q = v.to(torch.int8)
    elif fmt == "fp8":
        b = v.view(torch.int32).to(torch.int64)
        b &= _MASK32
        b += bits & 0xFFFFF
        b &= 0xFFF00000
        b -= (b >> 31) << 32                    # back to int32's range
        w = b.to(torch.int32).view(torch.float32)
        del b
        w = w.clamp(-448.0, 448.0)
        q = w.to(torch.float8_e4m3fn)
    else:
        raise ValueError(f"unknown quantize format {fmt!r}")
    del v
    hat = q.to(torch.float32)
    hat *= scale
    return q, hat


def quantize_ef_ref(x, err, key, row_offset, *, fmt: str):
    """Quantize one (R, C) chunk-row buffer with per-row scales and
    produce the EF21 residual (``ref.py:346-366``), the plain version of
    the quantize+EF kernel.

    x: (R, C); err: (R, C) or None, the carried residual added first
    (``s = x + err``); key: a uint32 int from :func:`sr_key`;
    row_offset: the global index of row 0.  Returns ``(q, scale,
    resid)``: q (R, C) int8 or float8_e4m3fn, scale (R, 1) f32, resid
    (R, C) f32 = s - q * scale."""
    if fmt not in _SR_QMAX:
        raise ValueError(f"unknown quantize format {fmt!r}")
    s = x.to(torch.float32)
    if err is not None:
        s = s + err.to(torch.float32)
    amax = s.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0.0, amax * _SR_INV_QMAX[fmt], 1.0)
    R, C = s.shape
    bits = _sr_bits(key, element_index(R, C, row_offset, s.device))
    q, hat = _quantize_core(s, scale, bits, fmt)
    del bits
    return q, scale, s - hat
