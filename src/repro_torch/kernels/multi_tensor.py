"""Segment tables for the grouped kernels: one launch over a list of
tensors (``csrc/multi_tensor.cuh`` reads them; its header says what each
word means and how the table reaches the card).

Each tensor is a segment: its pointers (the kernel's streams, inputs
first), its element count, its row length for a per-row scale (0: no
rows), the running sum of the chunk counts, and a flag for the 16-byte
vector loop.  A chunk is ``THREADS * UNROLL`` vectors of 16 bytes of the
input type and never crosses a segment.  A *row table*
(:func:`build_row_tables`, for the kernels with one scale per row) adds
a fifth word, the row offset, and cuts each segment into chunks of
whole rows (:func:`rows_per_chunk`).  A table holds at most
``TABLE_WORDS`` words, so a longer list becomes several tables, one
launch each.  Everything here is plain Python over integers (addresses
from ``data_ptr()``, element counts), so it is tested on the CPU, and the
kernels' host code checks every table it is given against the same
rules.  :func:`plan_buckets` cuts a list of tensors into the buckets the
callers hand to one grouped call each.
"""
from __future__ import annotations

from array import array
from typing import NamedTuple

# These match csrc/multi_tensor.cuh.
THREADS, UNROLL = 256, 4
WARPS = THREADS // 32
TABLE_WORDS = 3968
META_WORDS = 4              # numel, cols, chunk_end, vec
ROW_META_WORDS = 5          # the four, then row_offset
ROW_CHUNK_ELEMS = 4096

BUCKET_BYTES = 256 << 20    # f32 buffers gathered per grouped call


class Table(NamedTuple):
    """One launch's records, back to back, as 64-bit words."""
    words: array
    segments: int
    chunks: int


def vector_elems(elt_bytes: int) -> int:
    """Elements of a 16-byte vector of the input type."""
    return 16 // elt_bytes


def chunk_elems(elt_bytes: int) -> int:
    return THREADS * UNROLL * vector_elems(elt_bytes)


def capacity(nptr: int, meta: int = META_WORDS) -> int:
    """Segments of ``nptr`` pointers and ``meta`` words one table
    holds."""
    return TABLE_WORDS // (nptr + meta)


def rows_per_chunk(cols: int) -> int:
    """Whole rows of ``cols`` elements per chunk of a row table: as many
    as fit ``ROW_CHUNK_ELEMS`` elements, but one per warp at least."""
    return max(WARPS, ROW_CHUNK_ELEMS // cols)


def vector_ok(ptrs, cols: int, elt_bytes: int) -> bool:
    """The vector loop's condition: every pointer 16-byte aligned and the
    row length (0 where there are no rows) a multiple of the vector."""
    return (all(p % 16 == 0 for p in ptrs)
            and cols % vector_elems(elt_bytes) == 0)


def build_tables(segments, elt_bytes: int) -> list[Table]:
    """The tables for ``segments``, a sequence of ``(pointers, numel,
    cols)`` with the same number of pointers each, over an input type of
    ``elt_bytes`` bytes.  Segments of no elements are left out (their
    tensors need no work); the rest fill tables of at most
    :func:`capacity` segments, in order."""
    chunk = chunk_elems(elt_bytes)
    tables, words, count, chunks, nptr = [], array("Q"), 0, 0, None
    for ptrs, numel, cols in segments:
        ptrs = tuple(ptrs)
        if nptr is None:
            nptr = len(ptrs)
        if len(ptrs) != nptr:
            raise ValueError(f"every segment takes {nptr} pointers, got "
                             f"{len(ptrs)}")
        if numel < 0 or cols < 0:
            raise ValueError(f"numel {numel} and cols {cols} must be >= 0")
        if numel == 0:
            continue
        if count == capacity(nptr):
            tables.append(Table(words, count, chunks))
            words, count, chunks = array("Q"), 0, 0
        chunks += -(-numel // chunk)
        words.extend((*ptrs, numel, cols, chunks,
                      int(vector_ok(ptrs, cols, elt_bytes))))
        count += 1
    if count:
        tables.append(Table(words, count, chunks))
    return tables


def row_vector_ok(ptrs, cols: int, vec_cols: int, max_cols: int) -> bool:
    """A row kernel's vector loop: every pointer 16-byte aligned and the
    row length a multiple of ``vec_cols`` and at most ``max_cols``."""
    return (all(p % 16 == 0 for p in ptrs) and cols % vec_cols == 0
            and cols <= max_cols)


def build_row_tables(segments, vec_cols: int, max_cols: int) -> list[Table]:
    """The row tables for ``segments``, a sequence of ``(pointers, rows,
    cols, row_offset)`` with the same number of pointers each, cols >= 1;
    ``vec_cols`` and ``max_cols`` are the kernel's vector rule
    (:func:`row_vector_ok`).  Segments of no rows are left out; the rest
    fill tables of at most ``capacity(nptr, ROW_META_WORDS)`` segments,
    in order.  The row offset is stored as its 64-bit two's complement."""
    tables, words, count, chunks, nptr = [], array("Q"), 0, 0, None
    for ptrs, rows, cols, row_offset in segments:
        ptrs = tuple(ptrs)
        if nptr is None:
            nptr = len(ptrs)
        if len(ptrs) != nptr:
            raise ValueError(f"every segment takes {nptr} pointers, got "
                             f"{len(ptrs)}")
        if rows < 0 or cols < 1:
            raise ValueError(f"rows {rows} must be >= 0 and cols {cols} "
                             f">= 1")
        if rows == 0:
            continue
        if count == capacity(nptr, ROW_META_WORDS):
            tables.append(Table(words, count, chunks))
            words, count, chunks = array("Q"), 0, 0
        chunks += -(-rows // rows_per_chunk(cols))
        words.extend((*ptrs, rows * cols, cols, chunks,
                      int(row_vector_ok(ptrs, cols, vec_cols, max_cols)),
                      int(row_offset) % (1 << 64)))
        count += 1
    if count:
        tables.append(Table(words, count, chunks))
    return tables


def plan_buckets(sizes, cap: int) -> list[list[int]]:
    """Buckets for grouped calls: the indices of tensors whose buffers
    take ``sizes`` bytes, in order, cut so that a bucket's bytes stay
    within ``cap``; a tensor larger than the cap is a bucket of its own
    (``cap = 0``: one bucket per tensor)."""
    buckets, cur, held = [], [], 0
    for i, size in enumerate(sizes):
        if cur and held + size > cap:
            buckets.append(cur)
            cur, held = [], 0
        cur.append(i)
        held += size
    if cur:
        buckets.append(cur)
    return buckets


def groups(keys) -> dict:
    """Indices by key, keys and indices in the order first met: one
    launch (or more) per group, e.g. per dtype."""
    out: dict = {}
    for i, k in enumerate(keys):
        out.setdefault(k, []).append(i)
    return out
