"""Segment tables for the grouped kernels: one launch over a list of
tensors (``csrc/multi_tensor.cuh`` reads them; its header says what each
word means and how the table reaches the card).

Each tensor is a segment: its pointers (the kernel's streams, inputs
first), its element count, its row length for a per-row scale (0: no
rows), the running sum of the chunk counts, and a flag for the 16-byte
vector loop.  A chunk is ``THREADS * UNROLL`` vectors of 16 bytes of the
input type and never crosses a segment.  A table holds at most
``TABLE_WORDS`` words, so a longer list becomes several tables, one
launch each.  Everything here is plain Python over integers (addresses
from ``data_ptr()``, element counts), so it is tested on the CPU, and the
kernels' host code checks every table it is given against the same
rules.
"""
from __future__ import annotations

from array import array
from typing import NamedTuple

# These match csrc/multi_tensor.cuh.
THREADS, UNROLL = 256, 4
TABLE_WORDS = 3968
META_WORDS = 4              # numel, cols, chunk_end, vec


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


def capacity(nptr: int) -> int:
    """Segments of ``nptr`` pointers one table holds."""
    return TABLE_WORDS // (nptr + META_WORDS)


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


def groups(keys) -> dict:
    """Indices by key, keys and indices in the order first met: one
    launch (or more) per group, e.g. per dtype."""
    out: dict = {}
    for i, k in enumerate(keys):
        out.setdefault(k, []).append(i)
    return out
