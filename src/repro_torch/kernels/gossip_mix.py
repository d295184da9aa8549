"""Hand-written CUDA gossip combine for Hopper: the port of
``gossip_mix_slots_pallas`` and ``gossip_mix_pallas``
(``src/repro/kernels/gossip_mix.py:92`` and ``:69``), three entry points
into one kernel.

The kernel is ``csrc/gossip_mix.cu`` (its header says what it computes,
what bounds it and how it is built), fed from the segment tables of
:mod:`.multi_tensor`.  :func:`gossip_mix_slots_many` combines many
tensors' slots with one round's weights in one launch per pair of input
and output dtypes (the distributed mixer's bucket), and can write a bf16
output straight from the f32 sum.  :func:`gossip_mix_slots` takes S
separate buffers of one tensor (the distributed runtime's own buffer and
each received one) and :func:`gossip_mix_stacked` one ``(S, R, C)``
stack, each a one-segment table.  Each checks its inputs, allocates the
outputs, launches on PyTorch's current stream and counts its own
launches in ``launches`` (``gossip_mix_slots_many`` also the tensors
they covered, in ``segments``).  They take CUDA tensors only: the plain
version is :func:`repro_torch.kernels.ref.gossip_mix_ref`, chosen by
:func:`repro_torch.kernels.ops.gossip_mix` and
:func:`~repro_torch.kernels.ops.gossip_mix_many` from the device.
"""
from __future__ import annotations

import ctypes

import torch

from . import multi_tensor as mt
from ._build import load_library
from .ref import _f32_weights

MAX_SLOTS = 32          # the kernel's weight table (csrc/multi_tensor.cuh)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = load_library("gossip_mix")
    fn = lib.repro_gossip_mix_many
    if fn.argtypes is None:
        fn.argtypes = [_c_int, _c_int, _c_void_p, _c_int, _c_int,
                       ctypes.POINTER(ctypes.c_float), _c_void_p]
        fn.restype = _c_int
        lib.repro_gossip_mix_error_string.argtypes = [_c_int]
        lib.repro_gossip_mix_error_string.restype = ctypes.c_char_p
    return lib


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


def _launch(segments, in_dtype, out_dtype, weights, device):
    """One launch per table over ``segments`` (``(pointers, numel)``, the
    slot buffers then the output).  Returns (launches, segments)."""
    S = len(weights)
    w = (ctypes.c_float * S)(*weights)
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    launches = count = 0
    for table in mt.build_tables(((p, n, 0) for p, n in segments),
                                 in_dtype.itemsize):
        rc = lib.repro_gossip_mix_many(
            _DTYPE_CODES[in_dtype], _DTYPE_CODES[out_dtype],
            table.words.buffer_info()[0], table.segments, S, w, stream)
        if rc != 0:
            raise RuntimeError("gossip-mix kernel launch failed: "
                               + lib.repro_gossip_mix_error_string(rc)
                               .decode())
        launches += 1
        count += table.segments
    return launches, count


def _weights(weights, S: int) -> list[float]:
    w = _f32_weights(weights)
    if len(w) != S:
        raise ValueError(f"{S} slots need {S} weights, got {len(w)}")
    return w


def _slot_count(S: int, what: str) -> None:
    if not 1 <= S <= MAX_SLOTS:
        raise ValueError(f"{what} takes 1 to {MAX_SLOTS} buffers, got {S}")


def gossip_mix_slots_many(slot_lists, weights, out_dtype=None):
    """``sum_s weights[s] * bufs[s]`` for each tensor's ``bufs`` in
    ``slot_lists``, on the card, in one launch per (input, output) dtype
    pair present.

    slot_lists: T lists of S contiguous CUDA buffers each (1 <= S <= 32,
    slot 0 the node's own), all on one device; one tensor's buffers share
    one shape and dtype (float32 or bfloat16).  weights: S floats, one
    round's.  out_dtype: None (each tensor's own dtype), a dtype, or one
    dtype per tensor; a bf16 output is the f32 sum rounded once.  Returns
    T new tensors of the buffers' shapes."""
    lists = [list(b) for b in slot_lists]
    if not lists:
        return []
    S = len(lists[0])
    _slot_count(S, "gossip_mix_slots_many")
    if any(len(b) != S for b in lists):
        raise ValueError(f"gossip_mix_slots_many: every tensor takes {S} "
                         f"slots, got {[len(b) for b in lists]}")
    w = _weights(weights, S)
    dev = lists[0][0].device
    for bufs in lists:
        _check(bufs, "gossip_mix_slots_many")
        if bufs[0].device != dev:
            raise ValueError("gossip_mix_slots_many takes CUDA tensors on "
                             "one device")
        if any(b.shape != bufs[0].shape for b in bufs):
            raise ValueError(f"one tensor's slots must be one shape, got "
                             f"{[tuple(b.shape) for b in bufs]}")
    if out_dtype is None or isinstance(out_dtype, torch.dtype):
        outs = [out_dtype or b[0].dtype for b in lists]
    else:
        outs = list(out_dtype)
        if len(outs) != len(lists):
            raise ValueError(f"{len(lists)} tensors, {len(outs)} out_dtypes")
    if any(d not in _DTYPE_CODES for d in outs):
        raise TypeError(f"out_dtype must be float32/bfloat16, got {outs}")
    out = [torch.empty(b[0].shape, dtype=d, device=dev)
           for b, d in zip(lists, outs)]
    pairs = mt.groups((b[0].dtype, d) for b, d in zip(lists, outs))
    for (din, dout), idx in pairs.items():
        n, count = _launch(
            [((*(b.data_ptr() for b in lists[i]), out[i].data_ptr()),
              out[i].numel()) for i in idx], din, dout, w, dev)
        gossip_mix_slots_many.launches += n
        gossip_mix_slots_many.segments += count
    return out


def gossip_mix_slots(bufs, weights):
    """``sum_s weights[s] * bufs[s]`` on the card, in one launch.

    bufs: 1 to 32 contiguous (R, C) CUDA tensors of one shape and dtype
    (float32 or bfloat16), slot 0 the node's own buffer; weights: S
    floats.  Returns a new (R, C) tensor of the buffers' dtype."""
    bufs = list(bufs)
    S = len(bufs)
    _slot_count(S, "gossip_mix_slots")
    _check(bufs, "gossip_mix_slots")
    if bufs[0].ndim != 2 or any(b.shape != bufs[0].shape for b in bufs):
        raise ValueError(f"buffers must be one (R, C) shape, got "
                         f"{[tuple(b.shape) for b in bufs]}")
    w = _weights(weights, S)
    out = torch.empty_like(bufs[0])
    n, _ = _launch([((*(b.data_ptr() for b in bufs), out.data_ptr()),
                     out.numel())], out.dtype, out.dtype, w, out.device)
    gossip_mix_slots.launches += n
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
    step = out.numel() * stack.element_size()
    ptrs = tuple(stack.data_ptr() + s * step for s in range(S))
    n, _ = _launch([((*ptrs, out.data_ptr()), out.numel())], out.dtype,
                   out.dtype, w, out.device)
    gossip_mix_stacked.launches += n
    return out


gossip_mix_slots_many.launches = 0
gossip_mix_slots_many.segments = 0
gossip_mix_slots.launches = 0
gossip_mix_stacked.launches = 0
