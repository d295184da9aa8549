"""Hand-written CUDA quantize + EF21 residual for compressed gossip on
Hopper: the port of ``quantize_ef_pallas``
(``src/repro/kernels/quantized_gossip.py:71``).

The kernel is ``csrc/quantized_gossip.cu`` (its header says what it
computes, what bounds it and what its simple design leaves for later).
:func:`quantize_ef` checks its inputs, allocates the outputs and launches
the kernel on PyTorch's current stream; it counts each launch in
``quantize_ef.launches``.  It takes CUDA tensors only: the plain version
is :func:`repro_torch.kernels.ref.quantize_ef_ref`, chosen by
:func:`repro_torch.kernels.ops.quantize_payload` from the tensor's
device.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import load_library
from .ref import _SR_INV_QMAX

_FMT_CODES = {"int8": 0, "fp8": 1}
_PAYLOAD_DTYPE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
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
