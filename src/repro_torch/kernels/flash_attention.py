"""Hand-written CUDA flash attention for Hopper: the port of
``flash_attention_pallas`` (``src/repro/kernels/flash_attention.py:310``).

The kernel body is ``csrc/flash_core.cuh``, shared with the paged kernel
(its header says what it computes, the row contract it holds, how it uses
the tensor cores and what bounds it on the H100); ``csrc/flash_attention.cu``
launches it with dense key addressing.  :func:`flash_attention_fwd` checks
its inputs, allocates the output (and, for a split call, the f32 scratch)
and launches on PyTorch's current stream; it counts each attention call in
``flash_attention_fwd.launches`` (and by the caller's (D, Dv) pair in
``flash_attention_fwd.launches_by_dims``) and each launch of the split's
combine kernel in ``flash_attention_fwd.combine_launches``.  A head-dim
pair the kernel is not instantiated for is zero-padded to the smallest
instantiated pair that covers it (:func:`_pad_heads`), as the Pallas
kernel pads to its 128 lanes.  It takes CUDA tensors
only: the plain version for other devices is
:func:`repro_torch.kernels.ref.grouped_sdpa_ref`, chosen by
:mod:`repro_torch.kernels.ops` from the tensor's device.

What the TPU kernel needed and this one does not: every head dim
zero-padded to the 128-lane width (here only a pair the kernel lacks is
padded, to the nearest instantiated one), a ``(B*H, nq, nk)`` grid carrying the softmax
state in VMEM across a sequential kv axis, ``pl.when`` block skipping and
transposes around the call.  Here the kv loop runs inside the block over
the chunks its rows can see, a few-row call splits the key axis over
blocks to fill the SMs, and the kernel reads the model layout through
strides.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch
import torch.nn.functional as F

from ._build import load_library

#: (head dim, value head dim) pairs the kernel is instantiated for
SUPPORTED_DIMS = ((64, 64), (128, 128), (256, 256), (192, 128))
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_c_void_p, _c_int, _c_i64, _c_float = (ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int64, ctypes.c_float)
_ARGTYPES = ([_c_int] * 4 + [_c_void_p] * 4 + [_c_i64] * 5 + [_c_i64] * 12
             + [_c_void_p] * 2 + [_c_i64] * 2
             + [_c_int, _c_i64, _c_int, _c_float, _c_float]
             + [_c_int, _c_void_p, _c_void_p, _c_void_p])
#: a call of at most this many rows per (kv head, batch) takes 16-row
#: blocks and may split its key axis; more rows take 64-row blocks
_SMALL_ROWS = 64
_sm_counts: dict[int, int] = {}


def _lib() -> ctypes.CDLL:
    lib = load_library("flash_attention")
    fn = lib.repro_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _c_int
        lib.repro_cuda_error_string.argtypes = [_c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_flash_key_tile.argtypes = [_c_int]
        lib.repro_flash_key_tile.restype = _c_int
    return lib


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernel's 16-byte copies can read it (a contiguous last
    dim, the start and every other stride 16-byte aligned), else a copy
    in fresh memory (``contiguous()`` would return a contiguous tensor
    that starts off alignment as it is)."""
    e = t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st * e % 16 == 0 for st in t.stride()[:-1])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def choose_splits(kv_splits, *, blocks: int, rows: int, nchunks: int,
                  device) -> int:
    """Blocks over the key axis per row tile.  ``kv_splits`` (tests and
    the chip check) fixes it; ``None`` lets the wrapper fill the card:
    a call of at most 64 rows per kv head (decode, verify) whose
    ``blocks`` do not fill the SMs splits its chunks until they do.  A
    split never changes a result, only the route to it."""
    if kv_splits is not None:
        if int(kv_splits) < 1:
            raise ValueError(f"kv_splits must be >= 1, got {kv_splits}")
        return min(int(kv_splits), max(nchunks, 1))
    if rows > _SMALL_ROWS:
        return 1
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    sms = _sm_counts.get(idx)
    if sms is None:
        sms = _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    if blocks >= sms:
        return 1
    return max(1, min(nchunks, -(-sms // blocks)))


def split_scratch(splits: int, *, B: int, KV: int, row_tiles: int,
                  block_rows: int, nchunks: int, Dv: int, device):
    """The f32 scratch of a split call, one allocation, and the addresses
    of its two parts (n rows of Dv partial outputs, then n (m, l) pairs);
    (None, None, None) unsplit."""
    if splits == 1:
        return None, None, None
    n = B * KV * row_tiles * block_rows * nchunks
    buf = torch.empty(n * (Dv + 2), dtype=torch.float32, device=device)
    return buf, buf.data_ptr(), buf.data_ptr() + 4 * n * Dv


def _position_operand(x, B: int, device, what: str):
    """An int, or a (B,) int32 tensor on the kernel's device: returns
    (scalar, tensor-or-None) — the kernel reads the tensor when given."""
    if isinstance(x, torch.Tensor):
        if x.shape != (B,) or x.device != device:
            raise ValueError(f"{what} must be an int or a ({B},) tensor on "
                             f"{device}, got {tuple(x.shape)} on {x.device}")
        return 0, x.to(torch.int32).contiguous()
    return int(x), None


def _pad_heads(q, k, v, scale):
    """The kernel's (D, Dv) for any head dims, as the Pallas kernel's
    lane padding (``flash_attention.py:127-133``): a pair the kernel is
    not instantiated for is zero-padded to the smallest instantiated pair
    that covers it (reduced MLA's (48, 32) and (64, 32) to (64, 64)), the
    scale kept at ``D ** -0.5`` of the true D unless given.  Zero columns
    add nothing to q·k, and the padded value columns come out zero for
    the caller to slice off.  Returns ``(q, k, v, scale)``; raises for a
    pair no instantiation covers."""
    D, Dv = q.shape[-1], v.shape[-1]
    fits = [p for p in SUPPORTED_DIMS if p[0] >= D and p[1] >= Dv]
    if not fits:
        raise ValueError(f"head dims (D={D}, Dv={Dv}) exceed every "
                         f"instantiated pair: {SUPPORTED_DIMS}")
    pd, pdv = min(fits, key=sum)
    return (F.pad(q, (0, pd - D)), F.pad(k, (0, pd - D)),
            F.pad(v, (0, pdv - Dv)), D ** -0.5 if scale is None else scale)


def flash_attention_fwd(q, k, v, *, causal: bool = True, window=None,
                        softcap=None, scale=None, q_start=None,
                        k_valid_len=None, kv_splits=None) -> torch.Tensor:
    """Grouped-query flash attention on the card, in the model layout.

    q: (B, Tq, H, D);  k: (B, S, KV, D);  v: (B, S, KV, Dv), any strides
    with a contiguous last dim, one dtype (float32 or bfloat16), H % KV
    == 0.  ``q_start`` (default ``S - Tq``) and ``k_valid_len`` (default
    ``S``) are ints or (B,) tensors.  ``kv_splits`` (private: tests and
    the chip check) fixes the number of blocks over the key axis; the
    result is the same bits whatever it is.  Returns a (B, Tq, H, Dv)
    tensor of q's dtype: contiguous, or for a padded pair the leading Dv
    columns of one."""
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
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    pair = (D, Dv)
    if pair not in SUPPORTED_DIMS:
        q, k, v, scale = _pad_heads(q, k, v, scale)
        D, Dv = q.shape[-1], v.shape[-1]
    q, k, v = (aligned(t) for t in (q, k, v))
    if scale is None:
        scale = D ** -0.5
    q0, q_start_t = _position_operand(S - Tq if q_start is None
                                      else q_start, B, q.device, "q_start")
    kv0, k_valid_t = _position_operand(S if k_valid_len is None
                                       else k_valid_len, B, q.device,
                                       "k_valid_len")
    out = torch.empty((B, Tq, H, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out[..., :pair[1]]
    # Few rows (decode, verify) take blocks of one 16-row team; more rows
    # take four teams, which share each K/V tile.  A row's bits are the
    # same either way.
    rows = Tq * (H // KV)
    block_rows = 16 if rows <= _SMALL_ROWS else 64
    row_tiles = -(-rows // block_rows)
    lib = _lib()
    nchunks = -(-S // lib.repro_flash_key_tile(_DTYPE_CODES[q.dtype]))
    splits = choose_splits(kv_splits, blocks=row_tiles * KV * B, rows=rows,
                           nchunks=nchunks, device=q.device)
    # the scratch may be freed once the launches are queued: the caching
    # allocator hands its memory only to work queued after them on this
    # stream
    scratch, part_o, part_ml = split_scratch(
        splits, B=B, KV=KV, row_tiles=row_tiles, block_rows=block_rows,
        nchunks=nchunks, Dv=Dv, device=q.device)
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
        splits, part_o, part_ml,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("flash attention kernel launch failed: "
                           + lib.repro_cuda_error_string(rc).decode())
    flash_attention_fwd.launches += 1
    flash_attention_fwd.launches_by_dims[pair] += 1
    flash_attention_fwd.combine_launches += int(splits > 1)
    flash_attention_fwd.last_launch = dict(
        grid=(row_tiles * B, KV * splits, 1), threads=8 * block_rows,
        splits=splits)
    return out if Dv == pair[1] else out[..., :pair[1]]


flash_attention_fwd.launches = 0
#: the launches by the caller's (head dim, value head dim) pair
flash_attention_fwd.launches_by_dims = Counter()
flash_attention_fwd.combine_launches = 0
#: the grid, threads per block and key-axis split of the last call
flash_attention_fwd.last_launch = None
