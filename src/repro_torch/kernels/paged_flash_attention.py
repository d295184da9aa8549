"""Hand-written CUDA paged flash attention for Hopper: the port of
``paged_flash_attention_pallas``
(``src/repro/kernels/flash_attention.py:216``).

The kernel body is ``csrc/flash_core.cuh``, shared with the dense kernel
(its header says what it computes, the row contract that makes
speculative decoding lossless, how it uses the tensor cores and what
bounds it on the H100); ``csrc/paged_flash_attention.cu`` launches it
with page-table key addressing.  :func:`paged_flash_attention_fwd` checks
its inputs, allocates the output (and a split call's scratch) and
launches on PyTorch's current stream; it counts each attention call in
``paged_flash_attention_fwd.launches`` and each combine launch in
``paged_flash_attention_fwd.combine_launches``.  It takes CUDA tensors
only: the plain version for other devices is
:func:`repro_torch.kernels.ref.paged_sdpa_ref`, chosen by
:mod:`repro_torch.kernels.ops` from the tensor's device.

Where the TPU kernel lets a scalar-prefetched block table drive the
BlockSpec index maps, so each kv grid step fetches one whole page, this
kernel walks key tiles at absolute positions and looks each key's page
up in the table once per tile: any page size works, and the pools are
read in the model layout through strides.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import load_library
from .flash_attention import (_DTYPE_CODES, SUPPORTED_DIMS, aligned,
                              choose_splits, split_scratch)

_c_void_p, _c_int, _c_i64, _c_float = (ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int64, ctypes.c_float)
_ARGTYPES = ([_c_int] * 3 + [_c_void_p] * 7 + [_c_i64] * 6 + [_c_i64] * 13
             + [_c_int, _c_i64, _c_int, _c_float, _c_float]
             + [_c_int, _c_void_p, _c_void_p, _c_void_p])
_BLOCK_ROWS = 16


def _lib() -> ctypes.CDLL:
    lib = load_library("paged_flash_attention")
    fn = lib.repro_paged_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _c_int
        lib.repro_paged_cuda_error_string.argtypes = [_c_int]
        lib.repro_paged_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_paged_key_tile.argtypes = [_c_int]
        lib.repro_paged_key_tile.restype = _c_int
    return lib


def _per_slot(x, B: int, device, what: str) -> torch.Tensor:
    """An int or a (B,) integer tensor -> a contiguous (B,) int32 tensor on
    the kernel's device."""
    if isinstance(x, torch.Tensor):
        if x.shape != (B,) or x.device != device:
            raise ValueError(f"{what} must be an int or a ({B},) tensor on "
                             f"{device}, got {tuple(x.shape)} on {x.device}")
        return x.to(torch.int32).contiguous()
    return torch.full((B,), int(x), dtype=torch.int32, device=device)


def paged_flash_attention_fwd(q, k_pages, v_pages, block_table, *, q_start,
                              k_valid_len, causal: bool = True, window=None,
                              softcap=None, scale=None,
                              kv_splits=None) -> torch.Tensor:
    """Grouped-query attention over a paged KV cache, on the card.

    q: (B, Tq, H, D);  k_pages: (P, ps, KV, D);  v_pages: (P, ps, KV, Dv),
    any strides with a contiguous last dim, one dtype (float32 or
    bfloat16), H % KV == 0.  ``block_table``: (B, maxp) int32 on the card:
    slot b's positions ``[j*ps, (j+1)*ps)`` live at page
    ``block_table[b, j]``; the entries below ``ceil(k_valid_len / ps)``
    must be pages of the pool (not checked on the card).  ``q_start`` and
    ``k_valid_len`` are ints or (B,) tensors.  ``kv_splits`` (private:
    tests and the chip check) fixes the number of blocks over the key
    axis; the result is the same bits whatever it is.  Returns a
    contiguous (B, Tq, H, Dv) tensor of q's dtype."""
    B, Tq, H, D = q.shape
    P, ps, KV, Dk = k_pages.shape
    Dv = v_pages.shape[-1]
    if not (q.is_cuda and k_pages.is_cuda and v_pages.is_cuda
            and block_table.is_cuda):
        raise ValueError("paged_flash_attention_fwd takes CUDA tensors; the "
                         "plain version is ref.paged_sdpa_ref")
    if not q.dtype == k_pages.dtype == v_pages.dtype \
            or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q and the pools must share one dtype of "
                        f"float32/bfloat16, got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    if (Dk != D or v_pages.shape[:3] != k_pages.shape[:3] or H % KV
            or block_table.ndim != 2 or block_table.shape[0] != B):
        raise ValueError(f"incompatible shapes q {tuple(q.shape)}, pools "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}, "
                         f"block table {tuple(block_table.shape)}")
    if block_table.dtype != torch.int32 or block_table.stride(-1) != 1:
        raise TypeError("block_table must be int32 with a contiguous last "
                        "dim")
    if (D, Dv) not in SUPPORTED_DIMS:
        raise ValueError(f"head dims (D={D}, Dv={Dv}) not instantiated; "
                         f"supported: {SUPPORTED_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    q, k_pages, v_pages = (aligned(t) for t in (q, k_pages, v_pages))
    if scale is None:
        scale = D ** -0.5
    q_start = _per_slot(q_start, B, q.device, "q_start")
    k_valid = _per_slot(k_valid_len, B, q.device, "k_valid_len")
    out = torch.empty((B, Tq, H, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    rows = Tq * (H // KV)
    row_tiles = -(-rows // _BLOCK_ROWS)
    nchunks = -(-block_table.shape[1] * ps
                // lib.repro_paged_key_tile(_DTYPE_CODES[q.dtype]))
    splits = choose_splits(kv_splits, blocks=row_tiles * KV * B, rows=rows,
                           nchunks=nchunks, device=q.device)
    # the scratch may be freed once the launches are queued: the caching
    # allocator hands its memory only to work queued after them on this
    # stream
    scratch, part_o, part_ml = split_scratch(
        splits, B=B, KV=KV, row_tiles=row_tiles, block_rows=_BLOCK_ROWS,
        nchunks=nchunks, Dv=Dv, device=q.device)
    rc = lib.repro_paged_flash_attention_fwd(
        _DTYPE_CODES[q.dtype], D, Dv,
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), out.data_ptr(),
        block_table.data_ptr(), q_start.data_ptr(), k_valid.data_ptr(),
        B, Tq, H, KV, ps, block_table.shape[1],
        q.stride(0), q.stride(1), q.stride(2),
        k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
        v_pages.stride(0), v_pages.stride(1), v_pages.stride(2),
        out.stride(0), out.stride(1), out.stride(2), block_table.stride(0),
        int(bool(causal)), 0 if window is None else int(window),
        int(softcap is not None), float(softcap or 0.0), float(scale),
        splits, part_o, part_ml,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("paged flash attention kernel launch failed: "
                           + lib.repro_paged_cuda_error_string(rc).decode())
    paged_flash_attention_fwd.launches += 1
    paged_flash_attention_fwd.combine_launches += int(splits > 1)
    paged_flash_attention_fwd.last_launch = dict(
        grid=(row_tiles * B, KV * splits, 1), threads=8 * _BLOCK_ROWS,
        splits=splits)
    return out


paged_flash_attention_fwd.launches = 0
paged_flash_attention_fwd.combine_launches = 0
#: the grid, threads per block and key-axis split of the last call
paged_flash_attention_fwd.last_launch = None
