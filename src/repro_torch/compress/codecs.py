"""Gossip payload codec registry (the port of ``repro/compress/codecs.py``,
DESIGN.md Sec. 13).

Every codec works on the (R, C) **chunk-row layout**: a node's tensor is
raveled, zero-padded to a multiple of ``CompressionConfig.chunk`` and
reshaped to one row per scale group (``repro_torch.compress.mixing`` owns
the tensor <-> rows plumbing).  The contract is two functions:

    payload, residual = codec.compress(cfg, x2d, err2d | None, key,
                                       row_offset)
    hat2d             = codec.decode(cfg, payload)

* ``payload`` is a dict of tensors, exactly what goes on the wire; its
  dtypes are the wire format.
* ``residual`` is the exact EF21 carry ``(x + err) - hat`` in f32.
* ``key`` is a uint32 int from :func:`repro_torch.kernels.ref.sr_key`;
  ``row_offset`` the global index of row 0.

``int8`` and ``fp8`` go through ``repro_torch.kernels.ops`` (the CUDA
quantize+EF kernel on the card, its plain version on the CPU).  They also
have ``compress_many(cfg, x2ds, err2ds | None, key, row_offsets) ->
(payloads, residuals)``, the same for a bucket of buffers in one grouped
call (``ops.quantize_payload_many``), each buffer's bits those of
``compress`` on it alone.  Their ``fused_mix`` is True: the distributed
runtime combines their received payloads with
``ops.quantized_gossip_mix_many`` instead of decoding them.  ``int4``
and ``topk`` are plain PyTorch on both devices: the reference has no
kernel for them.  ``identity`` is a registry entry for byte accounting;
``repro_torch.compress.config.resolve`` turns it into the uncompressed
method before any codec runs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref


@dataclass(frozen=True)
class Codec:
    name: str
    compress: Callable
    decode: Callable
    # the payload is {"q", "scale"} that ops.quantized_gossip_mix(_many)
    # combines
    fused_mix: bool = False
    # a bucket of buffers in one grouped call, or None (one at a time)
    compress_many: Callable | None = None


CODECS: dict[str, Codec] = {}


def register_codec(codec: Codec) -> Codec:
    CODECS[codec.name] = codec
    return codec


def get_codec(name: str) -> Codec:
    try:
        return CODECS[name]
    except KeyError:
        raise ValueError(f"unknown codec {name!r}; registered: "
                         f"{sorted(CODECS)}") from None


def _sum_err(x, err):
    s = x.to(torch.float32)
    return s if err is None else s + err.to(torch.float32)


# ---------------------------------------------------------------------------
# identity
# ---------------------------------------------------------------------------

def _identity_compress(cfg, x, err, key, row_offset):
    s = _sum_err(x, err)
    return {"v": s}, torch.zeros_like(s)


def _identity_decode(cfg, payload):
    return payload["v"]


register_codec(Codec("identity", _identity_compress, _identity_decode))


# ---------------------------------------------------------------------------
# int8 / fp8: hash-SR quantizers with per-chunk scales (kernel-backed)
# ---------------------------------------------------------------------------

def _make_quant(fmt: str) -> Codec:
    def compress(cfg, x, err, key, row_offset):
        q, scale, resid = ops.quantize_payload(
            x, err, fmt=fmt, key=key, row_offset=row_offset)
        return {"q": q, "scale": scale}, resid

    def compress_many(cfg, xs, errs, key, row_offsets):
        qs, scales, resids = ops.quantize_payload_many(
            xs, errs, fmt=fmt, key=key, row_offsets=row_offsets)
        return ([{"q": q, "scale": sc} for q, sc in zip(qs, scales)],
                resids)

    def decode(cfg, payload):
        hat = payload["q"].to(torch.float32)
        hat *= payload["scale"]
        return hat

    return register_codec(Codec(fmt, compress, decode, fused_mix=True,
                                compress_many=compress_many))


_make_quant("int8")
_make_quant("fp8")


# ---------------------------------------------------------------------------
# int4: hash-SR quantizer, two values packed per wire byte
# ---------------------------------------------------------------------------

# float32(1/7): the scale is an explicit multiply, as for int8 and fp8
_INV7 = float(torch.tensor(1.0 / 7.0, dtype=torch.float32))


def _int4_compress(cfg, x, err, key, row_offset):
    s = _sum_err(x, err)
    R, C = s.shape
    amax = s.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0.0, amax * _INV7, 1.0)
    bits = kref._sr_bits(key, kref.element_index(R, C, row_offset,
                                                 s.device))
    u = bits.to(torch.float32)
    del bits
    u *= 2.0 ** -32
    v = s / scale
    v += u
    del u
    v.floor_()
    v.clamp_(-7.0, 7.0)
    q = v.to(torch.int32)
    hat = q.to(torch.float32)
    hat *= scale
    # pack biased nibbles ([-7, 7] -> [1, 15]) pairwise into uint8
    qb = (q + 8).to(torch.uint8).reshape(R, C // 2, 2)
    packed = qb[..., 0] | (qb[..., 1] << 4)
    return {"q": packed, "scale": scale}, s - hat


def _int4_decode(cfg, payload):
    p = payload["q"]
    R = p.shape[0]
    lo = (p & 0xF).to(torch.int32)
    hi = (p >> 4).to(torch.int32)
    q = torch.stack([lo, hi], dim=-1).reshape(R, -1) - 8
    hat = q.to(torch.float32)
    hat *= payload["scale"]
    return hat


register_codec(Codec("int4", _int4_compress, _int4_decode))


# ---------------------------------------------------------------------------
# topk: per-chunk magnitude sparsification (deterministic; EF carries the
# dropped mass)
# ---------------------------------------------------------------------------

def _topk_compress(cfg, x, err, key, row_offset):
    s = _sum_err(x, err)
    C = s.shape[1]
    # jax.lax.top_k's order: descending, the lower index first among equal
    # magnitudes (the zero-padded tail is all ties) -- a stable sort
    idx = torch.sort(s.abs(), dim=1, descending=True,
                     stable=True).indices[:, :cfg.topk_m]
    vals = torch.gather(s, 1, idx)
    payload = {"v": vals, "i": idx.to(torch.int32)}
    return payload, s - _topk_decode_shaped(payload, C)


def _topk_decode_shaped(payload, C):
    vals, idx = payload["v"], payload["i"]
    out = torch.zeros((vals.shape[0], C), dtype=torch.float32,
                      device=vals.device)
    return out.scatter_(1, idx.to(torch.int64), vals)


def _topk_decode(cfg, payload):
    return _topk_decode_shaped(payload, cfg.chunk)


register_codec(Codec("topk", _topk_compress, _topk_decode))
