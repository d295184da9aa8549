"""Hand-written CUDA fused DSGD-momentum update for Hopper: the port of
``fused_dsgd_pallas`` (``src/repro/kernels/fused_dsgd.py:50``).

The kernel is ``csrc/fused_dsgd.cu`` (its header says what it computes,
what bounds it and how it is built), fed from the segment tables of
:mod:`.multi_tensor`.  :func:`fused_dsgd_many` updates a list of leaves
in one launch per dtype present (more only where a list outgrows a
table): the training step's update of every leaf.  :func:`fused_dsgd` is
the same kernel on one (R, C) tensor, a one-segment table.  Both check
their inputs, allocate the outputs and launch on PyTorch's current
stream, and count their own launches (``fused_dsgd.launches``;
``fused_dsgd_many.launches`` and ``.segments``, the tensors its launches
covered).  They take CUDA tensors only: the plain version is
:func:`repro_torch.kernels.ref.fused_dsgd_ref`, chosen by
:func:`repro_torch.kernels.ops.fused_dsgd_step` and
:func:`~repro_torch.kernels.ops.fused_dsgd_steps` from the device.
"""
from __future__ import annotations

import ctypes

import torch

from . import multi_tensor as mt
from ._build import load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = ([_c_int, _c_void_p, _c_int, _c_void_p] + [_c_float] * 3
             + [_c_void_p])


def _lib() -> ctypes.CDLL:
    lib = load_library("fused_dsgd")
    fn = lib.repro_fused_dsgd_many
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _c_int
        lib.repro_fused_dsgd_error_string.argtypes = [_c_int]
        lib.repro_fused_dsgd_error_string.restype = ctypes.c_char_p
    return lib


def _pre(pre_scale, rows, device):
    """(pre tensor or None, pre0): a per-row (R,) f32 tensor on the
    leaves' device, or a float."""
    if isinstance(pre_scale, torch.Tensor) and pre_scale.ndim >= 1:
        if pre_scale.ndim != 1 or pre_scale.device != device or (
                rows is not None and pre_scale.shape[0] != rows):
            raise ValueError(f"pre_scale must be a float or an (R,) tensor "
                             f"on {device}, got {tuple(pre_scale.shape)} on "
                             f"{pre_scale.device}")
        return pre_scale.to(torch.float32).contiguous(), 1.0
    return None, float(pre_scale)


def _run(xs, us, gs, beta, eta, pre_scale, what):
    """Checks the leaves, allocates the outputs and launches the kernel
    over them, one table at a time.  Returns ``(xs', us', launches,
    segments)``."""
    if not len(xs) == len(us) == len(gs):
        raise ValueError(f"{what}: {len(xs)} x, {len(us)} u, {len(gs)} g")
    if not xs:
        return [], [], 0, 0
    dev = xs[0].device
    for x, u, g in zip(xs, us, gs):
        if not all(t.is_cuda and t.device == dev for t in (x, u, g)):
            raise ValueError(f"{what} takes CUDA tensors on one device; the "
                             f"plain version is ref.fused_dsgd_ref")
        if not x.dtype == u.dtype == g.dtype or x.dtype not in _DTYPE_CODES:
            raise TypeError(f"{what}: x, u, g must share one dtype of "
                            f"float32/bfloat16, got {x.dtype}, {u.dtype}, "
                            f"{g.dtype}")
        if u.shape != x.shape or g.shape != x.shape:
            raise ValueError(f"{what}: x, u, g must be one shape, got "
                             f"{tuple(x.shape)}, {tuple(u.shape)}, "
                             f"{tuple(g.shape)}")
        if not (x.is_contiguous() and u.is_contiguous()
                and g.is_contiguous()):
            raise ValueError(f"{what} takes contiguous tensors")
    pre_t, pre0 = _pre(pre_scale, None, dev)
    if pre_t is not None:
        R = pre_t.shape[0]
        bad = [tuple(x.shape) for x in xs if x.ndim == 0 or x.shape[0] != R]
        if bad:
            raise ValueError(f"{what}: a per-row pre_scale of {R} rows needs "
                             f"every leaf's first axis of {R}, got {bad}")
    x_new = [torch.empty_like(x) for x in xs]
    u_new = [torch.empty_like(u) for u in us]
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    pre_ptr = None if pre_t is None else pre_t.data_ptr()
    launches = segments = 0
    for dtype, idx in mt.groups(x.dtype for x in xs).items():
        segs = [((xs[i].data_ptr(), us[i].data_ptr(), gs[i].data_ptr(),
                  x_new[i].data_ptr(), u_new[i].data_ptr()), xs[i].numel(),
                 0 if pre_t is None else xs[i].numel() // pre_t.shape[0])
                for i in idx]
        for table in mt.build_tables(segs, xs[idx[0]].element_size()):
            rc = lib.repro_fused_dsgd_many(
                _DTYPE_CODES[dtype], table.words.buffer_info()[0],
                table.segments, pre_ptr, pre0, float(beta), float(eta),
                stream)
            if rc != 0:
                raise RuntimeError(
                    "fused DSGD kernel launch failed: "
                    + lib.repro_fused_dsgd_error_string(rc).decode())
            launches += 1
            segments += table.segments
    return x_new, u_new, launches, segments


def fused_dsgd_many(xs, us, gs, beta, eta, pre_scale=1.0):
    """``u' = beta*u + g;  x' = pre_scale * (x - eta*u')`` for every leaf,
    on the card, in one launch per dtype present.

    xs, us, gs: equal-length lists of contiguous CUDA tensors; each leaf's
    x, u, g share one shape and dtype (float32 or bfloat16).  pre_scale:
    a float, or an (R,) tensor on the leaves' device shared by every leaf,
    each of which has R as its first axis (the node axis).  Returns new
    lists ``(xs', us')``."""
    x_new, u_new, launches, segments = _run(list(xs), list(us), list(gs),
                                            beta, eta, pre_scale,
                                            "fused_dsgd_many")
    fused_dsgd_many.launches += launches
    fused_dsgd_many.segments += segments
    return x_new, u_new


def fused_dsgd(x, u, g, beta, eta, pre_scale=1.0):
    """``u' = beta*u + g;  x' = pre_scale * (x - eta*u')`` on the card.

    x, u, g: contiguous (R, C) CUDA tensors of one dtype (float32 or
    bfloat16); ``pre_scale`` is a float or an (R,) tensor on x's device
    (cast to float32).  Returns new ``(x', u')`` of x's dtype."""
    if not (x.is_cuda and u.is_cuda and g.is_cuda):
        raise ValueError("fused_dsgd takes CUDA tensors; the plain version "
                         "is ref.fused_dsgd_ref")
    if x.ndim != 2 or u.shape != x.shape or g.shape != x.shape:
        raise ValueError(f"x, u, g must be one (R, C) shape, got "
                         f"{tuple(x.shape)}, {tuple(u.shape)}, "
                         f"{tuple(g.shape)}")
    _pre(pre_scale, x.shape[0], x.device)
    x_new, u_new, launches, _ = _run([x], [u], [g], beta, eta, pre_scale,
                                     "fused_dsgd")
    fused_dsgd.launches += launches
    return x_new[0], u_new[0]


fused_dsgd.launches = 0
fused_dsgd_many.launches = 0
fused_dsgd_many.segments = 0
