"""Hand-written CUDA flash attention for Hopper: the port of
``flash_attention_pallas`` (``src/repro/kernels/flash_attention.py:310``).

The kernel is ``csrc/flash_attention.cu`` (its header says what it
computes, what bounds it on the H100 and what its simple design leaves
for later).  :func:`flash_attention_fwd` checks its inputs, allocates the
output and launches the kernel on PyTorch's current stream; it counts
each launch in ``flash_attention_fwd.launches``.  It takes CUDA tensors
only: the plain version for other devices is
:func:`repro_torch.kernels.ref.grouped_sdpa_ref`, chosen by
:mod:`repro_torch.kernels.ops` from the tensor's device.

What the TPU kernel needed and this one does not: head dims zero-padded
to the 128-lane width, a ``(B*H, nq, nk)`` grid carrying the softmax
state in VMEM across a sequential kv axis, ``pl.when`` block skipping and
transposes around the call.  Here the kv loop runs inside the block over
the band the block's rows can see, and the kernel reads the model layout
through strides.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import load_library

#: (head dim, value head dim) pairs the kernel is instantiated for
SUPPORTED_DIMS = ((64, 64), (128, 128), (256, 256), (192, 128))
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_c_void_p, _c_int, _c_i64, _c_float = (ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int64, ctypes.c_float)
_ARGTYPES = ([_c_int] * 4 + [_c_void_p] * 4 + [_c_i64] * 5 + [_c_i64] * 12
             + [_c_void_p] * 2 + [_c_i64] * 2
             + [_c_int, _c_i64, _c_int, _c_float, _c_float, _c_void_p])


def _lib() -> ctypes.CDLL:
    lib = load_library("flash_attention")
    fn = lib.repro_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _c_int
        lib.repro_cuda_error_string.argtypes = [_c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _position_operand(x, B: int, device, what: str):
    """An int, or a (B,) int32 tensor on the kernel's device: returns
    (scalar, tensor-or-None) — the kernel reads the tensor when given."""
    if isinstance(x, torch.Tensor):
        if x.shape != (B,) or x.device != device:
            raise ValueError(f"{what} must be an int or a ({B},) tensor on "
                             f"{device}, got {tuple(x.shape)} on {x.device}")
        return 0, x.to(torch.int32).contiguous()
    return int(x), None


def flash_attention_fwd(q, k, v, *, causal: bool = True, window=None,
                        softcap=None, scale=None, q_start=None,
                        k_valid_len=None) -> torch.Tensor:
    """Grouped-query flash attention on the card, in the model layout.

    q: (B, Tq, H, D);  k: (B, S, KV, D);  v: (B, S, KV, Dv), any strides
    with a contiguous last dim, one dtype (float32 or bfloat16), H % KV
    == 0.  ``q_start`` (default ``S - Tq``) and ``k_valid_len`` (default
    ``S``) are ints or (B,) tensors.  Returns a contiguous
    (B, Tq, H, Dv) tensor of q's dtype."""
    B, Tq, H, D = q.shape
    Bk, S, KV, Dk = k.shape
    Dv = v.shape[-1]
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_fwd takes CUDA tensors; the plain "
                         "version is ref.grouped_sdpa_ref")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q, k, v must share one dtype of float32/bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if Bk != B or Dk != D or v.shape[:3] != k.shape[:3] or H % KV:
        raise ValueError(f"incompatible shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if (D, Dv) not in SUPPORTED_DIMS:
        raise ValueError(f"head dims (D={D}, Dv={Dv}) not instantiated; "
                         f"supported: {SUPPORTED_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    if scale is None:
        scale = D ** -0.5
    q0, q_start_t = _position_operand(S - Tq if q_start is None
                                      else q_start, B, q.device, "q_start")
    kv0, k_valid_t = _position_operand(S if k_valid_len is None
                                       else k_valid_len, B, q.device,
                                       "k_valid_len")
    out = torch.empty((B, Tq, H, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    # Few rows (decode) take 16-row blocks: 64-row blocks would leave most
    # of their rows empty.
    block_rows = 16 if Tq * (H // KV) <= 16 else 64
    lib = _lib()
    rc = lib.repro_flash_attention_fwd(
        _DTYPE_CODES[q.dtype], D, Dv, block_rows,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Tq, H, KV, S,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        None if q_start_t is None else q_start_t.data_ptr(),
        None if k_valid_t is None else k_valid_t.data_ptr(),
        q0, kv0, int(bool(causal)), 0 if window is None else int(window),
        int(softcap is not None), float(softcap or 0.0), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("flash attention kernel launch failed: "
                           + lib.repro_cuda_error_string(rc).decode())
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
