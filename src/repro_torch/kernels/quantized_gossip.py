"""Hand-written CUDA kernels for compressed gossip on Hopper: quantize +
EF21 residual, the port of ``quantize_ef_pallas``
(``src/repro/kernels/quantized_gossip.py:71``), and the dequantize-and-
combine of a compressed round, the port of
``quantized_gossip_mix_slots_pallas`` (``:115``).

Both kernels are in ``csrc/quantized_gossip.cu`` (its header says what
they compute, what bounds them and what their simple design leaves for
later).  :func:`quantize_ef` and :func:`quantized_gossip_mix` check their
inputs, allocate the outputs and launch on PyTorch's current stream; each
counts its launches in its own ``launches``.  They take CUDA tensors
only: the plain versions are
:func:`repro_torch.kernels.ref.quantize_ef_ref` and
:func:`repro_torch.kernels.ref.quantized_gossip_mix_ref`, chosen by
:func:`repro_torch.kernels.ops.quantize_payload` and
:func:`repro_torch.kernels.ops.quantized_gossip_mix` from the tensors'
device.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import load_library
from .ref import _SR_INV_QMAX, _f32_weights

_FMT_CODES = {"int8": 0, "fp8": 1}
_PAYLOAD_DTYPE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
_PAYLOAD_FMT = {d: f for f, d in _PAYLOAD_DTYPE.items()}
MAX_MIX_SLOTS = 32      # the mix kernel's slot table
_c_void_p, _c_int, _c_i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = ([_c_int] + [_c_void_p] * 5
             + [ctypes.c_uint32, _c_i64, ctypes.c_float, _c_i64, _c_i64,
                _c_void_p])


def _lib() -> ctypes.CDLL:
    lib = load_library("quantized_gossip")
    fn = lib.repro_quantize_ef
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _c_int
        lib.repro_quantize_ef_error_string.argtypes = [_c_int]
        lib.repro_quantize_ef_error_string.restype = ctypes.c_char_p
        mix = lib.repro_quantized_gossip_mix
        mix.argtypes = [_c_int, _c_void_p, ctypes.POINTER(_c_void_p),
                        ctypes.POINTER(_c_void_p),
                        ctypes.POINTER(ctypes.c_float), _c_int, _c_void_p,
                        _c_i64, _c_i64, _c_void_p]
        mix.restype = _c_int
    return lib


def quantize_ef(x, err, key: int, row_offset: int = 0, *, fmt: str):
    """Per-row amax scale, hash stochastic rounding to ``fmt`` and the
    EF21 residual, on the card, in one launch.

    x, err: contiguous (R, C) float32 CUDA tensors, C >= 2 (err may be
    None); key: a uint32 int (``ref.sr_key``); row_offset: the global
    index of row 0.  Returns new ``(q, scale, resid)``: q (R, C) int8 or
    float8_e4m3fn, scale (R, 1) float32, resid (R, C) float32."""
    if fmt not in _FMT_CODES:
        raise ValueError(f"fmt must be one of {tuple(_FMT_CODES)}, got "
                         f"{fmt!r}")
    ins = (x,) if err is None else (x, err)
    if not all(t.is_cuda for t in ins):
        raise ValueError("quantize_ef takes CUDA tensors; the plain version "
                         "is ref.quantize_ef_ref")
    if not all(t.dtype == torch.float32 for t in ins):
        raise TypeError(f"x and err must be float32, got "
                        f"{[t.dtype for t in ins]}")
    if x.ndim != 2 or x.shape[1] < 2 or any(t.shape != x.shape
                                             for t in ins):
        raise ValueError(f"x and err must be one (R, C) shape with C >= 2, "
                         f"got {[tuple(t.shape) for t in ins]}")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("quantize_ef takes contiguous tensors")
    if err is not None and err.device != x.device:
        raise ValueError(f"x on {x.device}, err on {err.device}")
    R, C = x.shape
    q = torch.empty((R, C), dtype=_PAYLOAD_DTYPE[fmt], device=x.device)
    scale = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    resid = torch.empty_like(x)
    if R == 0:
        return q, scale, resid
    lib = _lib()
    rc = lib.repro_quantize_ef(
        _FMT_CODES[fmt], x.data_ptr(),
        None if err is None else err.data_ptr(), q.data_ptr(),
        scale.data_ptr(), resid.data_ptr(), int(key) & 0xFFFFFFFF,
        int(row_offset), _SR_INV_QMAX[fmt], R, C,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("quantize+EF kernel launch failed: "
                           + lib.repro_quantize_ef_error_string(rc).decode())
    quantize_ef.launches += 1
    return q, scale, resid


quantize_ef.launches = 0


def quantized_gossip_mix(own, q_slots, scale_slots, weights):
    """``w[0]*own + sum_s w[s+1] * (q_s * scale_s)`` on the card, in one
    launch, the dequantized payloads never written out.

    own: a contiguous (R, C) float32 CUDA tensor, the node's own exact
    chunk rows; q_slots: 0 to 32 received (R, C) payloads of one dtype,
    int8 or float8_e4m3fn; scale_slots: as many (R, 1) float32 scales;
    weights: S + 1 floats, the self weight first.  Returns a new (R, C)
    float32 tensor."""
    q_slots, scale_slots = list(q_slots), list(scale_slots)
    S = len(q_slots)
    if not 0 <= S <= MAX_MIX_SLOTS or len(scale_slots) != S:
        raise ValueError(f"quantized_gossip_mix takes 0 to {MAX_MIX_SLOTS} "
                         f"payloads with one scale each, got {S} payloads "
                         f"and {len(scale_slots)} scales")
    ins = [own, *q_slots, *scale_slots]
    if not all(t.is_cuda and t.device == own.device for t in ins):
        raise ValueError("quantized_gossip_mix takes CUDA tensors on one "
                         "device; the plain version is "
                         "ref.quantized_gossip_mix_ref")
    if own.dtype != torch.float32 or any(
            t.dtype != torch.float32 for t in scale_slots):
        raise TypeError("own and the scales must be float32")
    if S and (q_slots[0].dtype not in _PAYLOAD_FMT
              or any(q.dtype != q_slots[0].dtype for q in q_slots)):
        raise TypeError(f"payloads must share one dtype of int8/"
                        f"float8_e4m3fn, got {[q.dtype for q in q_slots]}")
    if own.ndim != 2 or any(q.shape != own.shape for q in q_slots) or any(
            sc.shape != (own.shape[0], 1) for sc in scale_slots):
        raise ValueError(f"own and payloads must be one (R, C) shape and "
                         f"scales (R, 1), got {[tuple(t.shape) for t in ins]}")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("quantized_gossip_mix takes contiguous tensors")
    w = _f32_weights(weights)
    if len(w) != S + 1:
        raise ValueError(f"{S} payloads need {S + 1} weights, got {len(w)}")
    out = torch.empty_like(own)
    R, C = own.shape
    if out.numel() == 0:
        return out
    lib = _lib()
    fmt = _FMT_CODES[_PAYLOAD_FMT[q_slots[0].dtype]] if S else 0
    rc = lib.repro_quantized_gossip_mix(
        fmt, own.data_ptr(), (_c_void_p * S)(*[q.data_ptr() for q in q_slots]),
        (_c_void_p * S)(*[sc.data_ptr() for sc in scale_slots]),
        (ctypes.c_float * (S + 1))(*w), S, out.data_ptr(), R, C,
        torch.cuda.current_stream(own.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("quantized gossip-mix kernel launch failed: "
                           + lib.repro_quantize_ef_error_string(rc).decode())
    quantized_gossip_mix.launches += 1
    return out


quantized_gossip_mix.launches = 0
