"""Hand-written CUDA kernels for compressed gossip on Hopper: quantize +
EF21 residual, the port of ``quantize_ef_pallas``
(``src/repro/kernels/quantized_gossip.py:71``), and the dequantize-and-
combine of a compressed round, the port of
``quantized_gossip_mix_slots_pallas`` (``:115``).

Both kernels are in ``csrc/quantized_gossip.cu`` (its header says what
they compute, what bounds them and how they are laid out), fed from the
row tables of :mod:`.multi_tensor`.  :func:`quantize_ef_many` quantizes a
list of chunk-row buffers (the reference leaves of a bucket), each with
its own row offset, in one launch per table and per mode (with or
without err); :func:`quantized_gossip_mix_many` combines a list of
buffers with the payloads each received, under one round's weights, in
one launch per table and payload dtype.  :func:`quantize_ef` and
:func:`quantized_gossip_mix` are one-segment calls of the same kernels.
Each checks its inputs, allocates the outputs, launches on PyTorch's
current stream and counts its launches in ``launches`` and the buffers
they covered in ``segments``.  They take CUDA tensors only: the plain
versions are :func:`repro_torch.kernels.ref.quantize_ef_ref` and
:func:`repro_torch.kernels.ref.quantized_gossip_mix_ref`, chosen by
:mod:`repro_torch.kernels.ops` from the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from . import multi_tensor as mt
from ._build import load_library
from .ref import _SR_INV_QMAX, _f32_weights

_FMT_CODES = {"int8": 0, "fp8": 1}
_PAYLOAD_DTYPE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
_PAYLOAD_FMT = {d: f for f, d in _PAYLOAD_DTYPE.items()}
MAX_MIX_SLOTS = 31      # the table's 32 weights: own's, then one per slot
QUANT_VEC_COLS = 256    # the quantize kernel's vector rows (the chunk)
MIX_VEC_COLS = 128      # the combine's: one 16-byte vector of own per lane
_INT64_MAX = (1 << 63) - 1
_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = load_library("quantized_gossip")
    fn = lib.repro_quantize_ef_many
    if fn.argtypes is None:
        fn.argtypes = [_c_int, _c_int, _c_void_p, _c_int, ctypes.c_uint32,
                       ctypes.c_float, _c_void_p]
        fn.restype = _c_int
        lib.repro_quantize_ef_error_string.argtypes = [_c_int]
        lib.repro_quantize_ef_error_string.restype = ctypes.c_char_p
        mix = lib.repro_quantized_gossip_mix_many
        mix.argtypes = [_c_int, _c_void_p, _c_int, _c_int,
                        ctypes.POINTER(ctypes.c_float), _c_void_p]
        mix.restype = _c_int
    return lib


def _raise(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.repro_quantize_ef_error_string(rc).decode())


def _check_fmt(fmt: str) -> None:
    if fmt not in _FMT_CODES:
        raise ValueError(f"fmt must be one of {tuple(_FMT_CODES)}, got "
                         f"{fmt!r}")


def _check_quantize_inputs(x, err, dev) -> None:
    ins = (x,) if err is None else (x, err)
    if not all(t.is_cuda and t.device == dev for t in ins):
        raise ValueError("quantize_ef takes CUDA tensors on one device; the "
                         "plain version is ref.quantize_ef_ref")
    if not all(t.dtype == torch.float32 for t in ins):
        raise TypeError(f"x and err must be float32, got "
                        f"{[t.dtype for t in ins]}")
    if x.ndim != 2 or x.shape[1] < 2 or any(t.shape != x.shape
                                             for t in ins):
        raise ValueError(f"x and err must be one (R, C) shape with C >= 2, "
                         f"got {[tuple(t.shape) for t in ins]}")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("quantize_ef takes contiguous tensors")


def _quantize(xs, errs, key, row_offsets, fmt):
    """Checks, allocates and launches; returns ``(qs, scales, resids,
    launches)``."""
    _check_fmt(fmt)
    xs = list(xs)
    errs = [None] * len(xs) if errs is None else list(errs)
    row_offsets = list(row_offsets)
    if not len(xs) == len(errs) == len(row_offsets):
        raise ValueError(f"{len(xs)} x, {len(errs)} err, "
                         f"{len(row_offsets)} row offsets")
    if not xs:
        return [], [], [], 0
    dev = xs[0].device
    for x, e in zip(xs, errs):
        _check_quantize_inputs(x, e, dev)
    qs = [torch.empty(x.shape, dtype=_PAYLOAD_DTYPE[fmt], device=dev)
          for x in xs]
    scales = [torch.empty((x.shape[0], 1), dtype=torch.float32, device=dev)
              for x in xs]
    resids = [torch.empty_like(x) for x in xs]
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = int(key) & 0xFFFFFFFF
    launches = 0
    for with_err, idx in mt.groups(e is not None for e in errs).items():
        segs = []
        for i in idx:
            ptrs = [xs[i].data_ptr()]
            if with_err:
                ptrs.append(errs[i].data_ptr())
            ptrs += [qs[i].data_ptr(), scales[i].data_ptr(),
                     resids[i].data_ptr()]
            segs.append((ptrs, xs[i].shape[0], xs[i].shape[1],
                         int(row_offsets[i])))
        for table in mt.build_row_tables(segs, QUANT_VEC_COLS,
                                         QUANT_VEC_COLS):
            _raise(lib, lib.repro_quantize_ef_many(
                _FMT_CODES[fmt], int(with_err), table.words.buffer_info()[0],
                table.segments, key, _SR_INV_QMAX[fmt], stream), "quantize+EF")
            launches += 1
    return qs, scales, resids, launches


def quantize_ef_many(xs, errs, key: int, row_offsets, *, fmt: str):
    """Per-row amax scale, hash stochastic rounding to ``fmt`` and the
    EF21 residual of each buffer of ``xs``, on the card, in one launch per
    table and mode (with or without err).

    xs: contiguous (R_i, C_i) float32 CUDA tensors on one device, C_i >=
    2; errs: None, or one per x (each a tensor of x's shape, or None);
    key: a uint32 int (``ref.sr_key``); row_offsets: the global index of
    each buffer's row 0.  Returns the lists ``(qs, scales, resids)``: q
    (R_i, C_i) int8 or float8_e4m3fn, scale (R_i, 1) float32, resid
    (R_i, C_i) float32."""
    qs, scales, resids, n = _quantize(xs, errs, key, row_offsets, fmt)
    quantize_ef_many.launches += n
    quantize_ef_many.segments += sum(1 for q in qs if q.numel())
    return qs, scales, resids


def quantize_ef(x, err, key: int, row_offset: int = 0, *, fmt: str):
    """:func:`quantize_ef_many` of one buffer: x, err (or None) one
    contiguous (R, C) float32 CUDA tensor each, C >= 2.  Returns new
    ``(q, scale, resid)``."""
    (q,), (scale,), (resid,), n = _quantize([x], [err], key, [row_offset],
                                            fmt)
    quantize_ef.launches += n
    quantize_ef.segments += n
    return q, scale, resid


def _mix(owns, q_lists, scale_lists, weights):
    """Checks, allocates and launches; returns ``(outs, launches)``."""
    owns = [own for own in owns]
    q_lists = [list(q) for q in q_lists]
    scale_lists = [list(sc) for sc in scale_lists]
    if not len(owns) == len(q_lists) == len(scale_lists):
        raise ValueError(f"{len(owns)} own buffers, {len(q_lists)} payload "
                         f"lists, {len(scale_lists)} scale lists")
    w = _f32_weights(weights)
    S = len(w) - 1
    if not 0 <= S <= MAX_MIX_SLOTS:
        raise ValueError(f"quantized_gossip_mix takes 0 to {MAX_MIX_SLOTS} "
                         f"payloads with one scale each and S + 1 weights, "
                         f"got {len(w)} weights")
    if not owns:
        return [], 0
    dev = owns[0].device
    for own, qs, scs in zip(owns, q_lists, scale_lists):
        if len(qs) != S or len(scs) != S:
            raise ValueError(f"{S + 1} weights need {S} payloads with one "
                             f"scale each, got {len(qs)} payloads and "
                             f"{len(scs)} scales")
        ins = [own, *qs, *scs]
        if not all(t.is_cuda and t.device == dev for t in ins):
            raise ValueError("quantized_gossip_mix takes CUDA tensors on one "
                             "device; the plain version is "
                             "ref.quantized_gossip_mix_ref")
        if own.dtype != torch.float32 or any(
                t.dtype != torch.float32 for t in scs):
            raise TypeError("own and the scales must be float32")
        if S and (qs[0].dtype not in _PAYLOAD_FMT
                  or any(q.dtype != qs[0].dtype for q in qs)):
            raise TypeError(f"payloads must share one dtype of int8/"
                            f"float8_e4m3fn, got {[q.dtype for q in qs]}")
        if own.ndim != 2 or any(q.shape != own.shape for q in qs) or any(
                sc.shape != (own.shape[0], 1) for sc in scs):
            raise ValueError(f"own and payloads must be one (R, C) shape "
                             f"and scales (R, 1), got "
                             f"{[tuple(t.shape) for t in ins]}")
        if not all(t.is_contiguous() for t in ins):
            raise ValueError("quantized_gossip_mix takes contiguous tensors")
    outs = [torch.empty_like(own) for own in owns]
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    cw = (ctypes.c_float * (S + 1))(*w)
    launches = 0
    fmts = mt.groups(_FMT_CODES[_PAYLOAD_FMT[qs[0].dtype]] if S else 0
                     for qs in q_lists)
    for fmt, idx in fmts.items():
        segs = [([owns[i].data_ptr(), *(q.data_ptr() for q in q_lists[i]),
                  *(sc.data_ptr() for sc in scale_lists[i]),
                  outs[i].data_ptr()], owns[i].shape[0], owns[i].shape[1], 0)
                for i in idx if owns[i].shape[1] > 0]
        for table in mt.build_row_tables(segs, MIX_VEC_COLS, _INT64_MAX):
            _raise(lib, lib.repro_quantized_gossip_mix_many(
                fmt, table.words.buffer_info()[0], table.segments, S, cw,
                stream), "quantized gossip-mix")
            launches += 1
    return outs, launches


def quantized_gossip_mix_many(owns, q_lists, scale_lists, weights):
    """``w[0]*own + sum_s w[s+1] * (q_s * scale_s)`` for each buffer of
    ``owns`` and the payloads it received, on the card, in one launch per
    table and payload dtype, the dequantized payloads never written out.

    owns: contiguous (R_i, C_i) float32 CUDA tensors on one device, each
    buffer's own exact chunk rows; q_lists: per buffer its S received
    (R_i, C_i) payloads of one dtype, int8 or float8_e4m3fn; scale_lists:
    per buffer its S (R_i, 1) float32 scales; weights: S + 1 floats, one
    round's, the self weight first, 0 <= S <= 31.  Returns new (R_i, C_i)
    float32 tensors."""
    outs, n = _mix(owns, q_lists, scale_lists, weights)
    quantized_gossip_mix_many.launches += n
    quantized_gossip_mix_many.segments += sum(1 for o in outs if o.numel())
    return outs


def quantized_gossip_mix(own, q_slots, scale_slots, weights):
    """:func:`quantized_gossip_mix_many` of one buffer: own a contiguous
    (R, C) float32 CUDA tensor, q_slots 0 to 31 received (R, C) payloads
    of one dtype, scale_slots as many (R, 1) float32 scales, weights S + 1
    floats.  Returns a new (R, C) float32 tensor."""
    q_slots, scale_slots = list(q_slots), list(scale_slots)
    if len(q_slots) != len(scale_slots):
        raise ValueError(f"{len(q_slots)} payloads need one scale each, got "
                         f"{len(scale_slots)} scales")
    (out,), n = _mix([own], [q_slots], [scale_slots], weights)
    quantized_gossip_mix.launches += n
    quantized_gossip_mix.segments += n
    return out


quantize_ef_many.launches = quantize_ef_many.segments = 0
quantize_ef.launches = quantize_ef.segments = 0
quantized_gossip_mix_many.launches = quantized_gossip_mix_many.segments = 0
quantized_gossip_mix.launches = quantized_gossip_mix.segments = 0
