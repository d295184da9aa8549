"""Hand-written CUDA gossip combine for Hopper: the port of
``gossip_mix_slots_pallas`` and ``gossip_mix_pallas``
(``src/repro/kernels/gossip_mix.py:92`` and ``:69``), two entry points
into one kernel.

The kernel is ``csrc/gossip_mix.cu`` (its header says what it computes,
what bounds it and what its simple design leaves for later).
:func:`gossip_mix_slots` takes S separate buffers (the distributed
runtime's own buffer and each received one) and :func:`gossip_mix_stacked`
one ``(S, R, C)`` stack; each checks its inputs, allocates the output and
launches the kernel on PyTorch's current stream, and counts each launch
in its own ``launches``.  They take CUDA tensors only: the plain version
is :func:`repro_torch.kernels.ref.gossip_mix_ref`, chosen by
:func:`repro_torch.kernels.ops.gossip_mix` from the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import load_library
from .ref import _f32_weights

MAX_SLOTS = 32          # the kernel's slot table (csrc/gossip_mix.cu)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_c_void_p, _c_int, _c_i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_F32P = ctypes.POINTER(ctypes.c_float)


def _lib() -> ctypes.CDLL:
    lib = load_library("gossip_mix")
    if lib.repro_gossip_mix_slots.argtypes is None:
        lib.repro_gossip_mix_slots.argtypes = [
            _c_int, ctypes.POINTER(_c_void_p), _F32P, _c_int, _c_void_p,
            _c_i64, _c_void_p]
        lib.repro_gossip_mix_stacked.argtypes = [
            _c_int, _c_void_p, _F32P, _c_int, _c_void_p, _c_i64, _c_void_p]
        for fn in (lib.repro_gossip_mix_slots, lib.repro_gossip_mix_stacked):
            fn.restype = _c_int
        lib.repro_gossip_mix_error_string.argtypes = [_c_int]
        lib.repro_gossip_mix_error_string.restype = ctypes.c_char_p
    return lib


def _weights(weights, S: int):
    w = _f32_weights(weights)
    if len(w) != S:
        raise ValueError(f"{S} slots need {S} weights, got {len(w)}")
    return (ctypes.c_float * S)(*w)


def _check(bufs, what: str):
    b0 = bufs[0]
    if not all(b.is_cuda and b.device == b0.device for b in bufs):
        raise ValueError(f"{what} takes CUDA tensors on one device; the "
                         f"plain version is ref.gossip_mix_ref")
    if b0.dtype not in _DTYPE_CODES or any(b.dtype != b0.dtype
                                           for b in bufs):
        raise TypeError(f"{what}: buffers must share one dtype of "
                        f"float32/bfloat16, got {[b.dtype for b in bufs]}")
    if not all(b.is_contiguous() for b in bufs):
        raise ValueError(f"{what} takes contiguous tensors")


def _raise_on(rc: int, lib) -> None:
    if rc != 0:
        raise RuntimeError("gossip-mix kernel launch failed: "
                           + lib.repro_gossip_mix_error_string(rc).decode())


def gossip_mix_slots(bufs, weights):
    """``sum_s weights[s] * bufs[s]`` on the card, in one launch.

    bufs: 1 to 32 contiguous (R, C) CUDA tensors of one shape and dtype
    (float32 or bfloat16), slot 0 the node's own buffer; weights: S
    floats.  Returns a new (R, C) tensor of the buffers' dtype."""
    bufs = list(bufs)
    S = len(bufs)
    if not 1 <= S <= MAX_SLOTS:
        raise ValueError(f"gossip_mix_slots takes 1 to {MAX_SLOTS} buffers, "
                         f"got {S}")
    _check(bufs, "gossip_mix_slots")
    if bufs[0].ndim != 2 or any(b.shape != bufs[0].shape for b in bufs):
        raise ValueError(f"buffers must be one (R, C) shape, got "
                         f"{[tuple(b.shape) for b in bufs]}")
    w = _weights(weights, S)
    out = torch.empty_like(bufs[0])
    if out.numel() == 0:
        return out
    lib = _lib()
    ptrs = (_c_void_p * S)(*[b.data_ptr() for b in bufs])
    _raise_on(lib.repro_gossip_mix_slots(
        _DTYPE_CODES[out.dtype], ptrs, w, S, out.data_ptr(), out.numel(),
        torch.cuda.current_stream(out.device).cuda_stream), lib)
    gossip_mix_slots.launches += 1
    return out


def gossip_mix_stacked(stack, weights):
    """``sum_s weights[s] * stack[s]`` on the card, in one launch.

    stack: a contiguous (S, R, C) CUDA tensor, 1 <= S <= 32, float32 or
    bfloat16; weights: S floats.  Returns a new (R, C) tensor of the
    stack's dtype."""
    if stack.ndim != 3 or not 1 <= stack.shape[0] <= MAX_SLOTS:
        raise ValueError(f"gossip_mix_stacked takes an (S, R, C) stack with "
                         f"1 <= S <= {MAX_SLOTS}, got {tuple(stack.shape)}")
    _check([stack], "gossip_mix_stacked")
    S = stack.shape[0]
    w = _weights(weights, S)
    out = torch.empty(stack.shape[1:], dtype=stack.dtype, device=stack.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    _raise_on(lib.repro_gossip_mix_stacked(
        _DTYPE_CODES[out.dtype], stack.data_ptr(), w, S, out.data_ptr(),
        out.numel(), torch.cuda.current_stream(out.device).cuda_stream), lib)
    gossip_mix_stacked.launches += 1
    return out


gossip_mix_slots.launches = 0
gossip_mix_stacked.launches = 0
