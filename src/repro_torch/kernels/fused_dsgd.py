"""Hand-written CUDA fused DSGD-momentum update for Hopper: the port of
``fused_dsgd_pallas`` (``src/repro/kernels/fused_dsgd.py:50``).

The kernel is ``csrc/fused_dsgd.cu`` (its header says what it computes,
what bounds it and what its simple design leaves for later).
:func:`fused_dsgd` checks its inputs, allocates the outputs and launches
the kernel on PyTorch's current stream; it counts each launch in
``fused_dsgd.launches``.  It takes CUDA tensors only: the plain version
is :func:`repro_torch.kernels.ref.fused_dsgd_ref`, chosen by
:func:`repro_torch.kernels.ops.fused_dsgd_step` from the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_c_void_p, _c_int, _c_i64, _c_float = (ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int64, ctypes.c_float)
_ARGTYPES = ([_c_int] + [_c_void_p] * 6 + [_c_float] * 3 + [_c_i64] * 2
             + [_c_void_p])


def _lib() -> ctypes.CDLL:
    lib = load_library("fused_dsgd")
    fn = lib.repro_fused_dsgd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _c_int
        lib.repro_fused_dsgd_error_string.argtypes = [_c_int]
        lib.repro_fused_dsgd_error_string.restype = ctypes.c_char_p
    return lib


def fused_dsgd(x, u, g, beta, eta, pre_scale=1.0):
    """``u' = beta*u + g;  x' = pre_scale * (x - eta*u')`` on the card.

    x, u, g: contiguous (R, C) CUDA tensors of one dtype (float32 or
    bfloat16); ``pre_scale`` is a float or an (R,) tensor on x's device
    (cast to float32).  Returns new ``(x', u')`` of x's dtype."""
    if not (x.is_cuda and u.is_cuda and g.is_cuda):
        raise ValueError("fused_dsgd takes CUDA tensors; the plain version "
                         "is ref.fused_dsgd_ref")
    if not x.dtype == u.dtype == g.dtype or x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x, u, g must share one dtype of float32/bfloat16, "
                        f"got {x.dtype}, {u.dtype}, {g.dtype}")
    if x.ndim != 2 or u.shape != x.shape or g.shape != x.shape:
        raise ValueError(f"x, u, g must be one (R, C) shape, got "
                         f"{tuple(x.shape)}, {tuple(u.shape)}, "
                         f"{tuple(g.shape)}")
    if not (x.is_contiguous() and u.is_contiguous() and g.is_contiguous()):
        raise ValueError("fused_dsgd takes contiguous tensors")
    R, C = x.shape
    pre_t, pre0 = None, 1.0
    if isinstance(pre_scale, torch.Tensor):
        if pre_scale.shape != (R,) or pre_scale.device != x.device:
            raise ValueError(f"pre_scale must be a float or a ({R},) tensor "
                             f"on {x.device}, got {tuple(pre_scale.shape)} "
                             f"on {pre_scale.device}")
        pre_t = pre_scale.to(torch.float32).contiguous()
    else:
        pre0 = float(pre_scale)
    x_new, u_new = torch.empty_like(x), torch.empty_like(u)
    if x.numel() == 0:
        return x_new, u_new
    lib = _lib()
    rc = lib.repro_fused_dsgd(
        _DTYPE_CODES[x.dtype], x.data_ptr(), u.data_ptr(), g.data_ptr(),
        x_new.data_ptr(), u_new.data_ptr(),
        None if pre_t is None else pre_t.data_ptr(), pre0, float(beta),
        float(eta), R, C, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("fused DSGD kernel launch failed: "
                           + lib.repro_fused_dsgd_error_string(rc).decode())
    fused_dsgd.launches += 1
    return x_new, u_new


fused_dsgd.launches = 0
