"""Chunk-row plumbing and the dense compressed gossip mix (the port of
``repro/compress/mixing.py``).

The codecs work on a (rows, chunk) f32 layout with one scale per row;
this module maps the node-stacked tensors of a flat dict to that layout
and back, and runs the simulation engine's mixing step:

    out = diag(W) * x + offdiag(W) @ dequant(Q(x + e))
    e'  = (x + e) - dequant(Q(x + e))

The self term uses the node's **exact** value, as in the reference: a
node never transmits (so never quantizes) its own values to itself.
Each node's rows are padded on their own and row indices are global
across the node stack (node i's rows start at ``i * rows_per_node``), so
one node's rows quantized alone (row_offset ``i * rows_per_node``) hash
the same stochastic-rounding bits as the whole stack (row_offset 0).

The port's flat dict holds one tensor per block
(``stack.blocks.<block>.<pos>.…``) where the reference stacks the blocks
into one leaf (``stack.blocks.<pos>.…``, shape ``(n, num_blocks, …)``).
:func:`compressed_dense_mix` quantizes the reference's leaves: the block
tensors of one leaf are laid out together, each node's blocks back to
back in block order and padded once, as ``leaf_to_rows`` lays out the
stacked leaf.  So every row, element index and hash bit is the
reference's, and the payload and residual of a flat dict equal the
reference's on its own stacked tree.

The leaves are quantized in buckets: consecutive reference leaves whose
f32 chunk rows (all n nodes) stay within :data:`BUCKET_BYTES` go through
one ``codec.compress_many`` call (:func:`compress_bucket`), on the card
one grouped launch of the quantize+EF kernel (int8 and fp8; the other
codecs quantize leaf by leaf).  A leaf larger than the cap (the
embedding at full width) is a bucket of its own.
"""
from __future__ import annotations

import torch

from repro_torch import trace
from repro_torch.convert import _BLOCKS
from repro_torch.kernels.multi_tensor import BUCKET_BYTES, plan_buckets
from repro_torch.kernels.ref import sr_key

from .codecs import get_codec
from .config import CompressionConfig


def flat_to_rows(flat: torch.Tensor, chunk: int) -> torch.Tensor:
    """(P,) -> (rows, chunk) f32, zero-padded.  Padding lanes quantize to
    zero and carry zero residual, so :func:`rows_to_flat` drops them
    losslessly."""
    return leaf_to_rows(flat[None], chunk)


def rows_to_flat(r2d: torch.Tensor, n_params: int) -> torch.Tensor:
    """Inverse of :func:`flat_to_rows`."""
    return r2d.reshape(-1)[:n_params]


def leaf_to_rows(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """Node-stacked tensor (n, *rest) -> (n * rows_per_node, chunk) f32,
    each node's payload zero-padded on its own so that its rows are
    contiguous (global row = node * rows_per_node + row).  An f32 tensor
    that needs no padding comes back as a view."""
    return group_to_rows([x], chunk)


def rows_to_leaf(r2d: torch.Tensor, shape) -> torch.Tensor:
    """Inverse of :func:`leaf_to_rows` (f32)."""
    return rows_to_group(r2d, shape, 1)[0]


def group_to_rows(xs, chunk: int) -> torch.Tensor:
    """Node-stacked tensors of one shape (n, *rest), the blocks of one
    reference leaf in block order -> (n * rows_per_node, chunk) f32: node
    i's rows hold its blocks' values back to back, zero-padded once.
    This is :func:`leaf_to_rows` of the stacked leaf (n, len(xs), *rest)
    without the stacked copy; one f32 tensor that needs no padding comes
    back as a view."""
    n = xs[0].shape[0]
    p = xs[0][0].numel()
    rows = max(1, -(-len(xs) * p // chunk))
    if len(xs) == 1 and rows * chunk == p:       # no padding
        return xs[0].reshape(n, p).to(torch.float32).reshape(-1, chunk)
    out = torch.zeros((n, rows * chunk), dtype=torch.float32,
                      device=xs[0].device)
    for b, x in enumerate(xs):
        out[:, b * p:(b + 1) * p] = x.reshape(n, p)
    return out.reshape(n * rows, chunk)


def rows_bytes(xs, chunk: int) -> int:
    """Bytes of :func:`group_to_rows` of ``xs`` (f32 chunk rows)."""
    p = xs[0][0].numel()
    return 4 * xs[0].shape[0] * max(1, -(-len(xs) * p // chunk)) * chunk


def rows_to_group(r2d: torch.Tensor, shape, count: int) -> list:
    """Inverse of :func:`group_to_rows`: ``count`` f32 views of ``shape``
    (n, *rest)."""
    n = shape[0]
    p = 1
    for d in shape[1:]:
        p *= d
    flat = r2d.reshape(n, -1)
    return [flat[:, b * p:(b + 1) * p].reshape(shape) for b in range(count)]


def reference_leaves(keys) -> list[list[str]]:
    """The port's flat keys grouped into the reference's leaves: the keys
    ``stack.blocks.<b>.<pos>.<name>`` of one ``(pos, name)`` together in
    block order, every other key alone."""
    groups: dict[str, list] = {}
    for k in keys:
        m = _BLOCKS.match(k)
        leaf = k if m is None else f"{m[1]}.{m[3]}"
        groups.setdefault(leaf, []).append((0 if m is None else int(m[2]),
                                            k))
    return [[k for _, k in sorted(g)] for g in groups.values()]


def compress_bucket(codec, cfg, x2ds, e2ds, key, row_offsets):
    """A bucket's ``(payloads, residuals)``: one grouped call where the
    codec has one (int8, fp8), else the bucket's one buffer alone."""
    if codec.compress_many is not None:
        return codec.compress_many(cfg, x2ds, e2ds, key, row_offsets)
    payload, resid = codec.compress(cfg, x2ds[0],
                                    None if e2ds is None else e2ds[0], key,
                                    row_offsets[0])
    return [payload], [resid]


def compressed_dense_mix(W: torch.Tensor, tree: dict, ef: dict | None,
                         cfg: CompressionConfig, t: int):
    """One compressed gossip round against a dense (n, n) mixing matrix,
    or a (G, n, n) stack for G copies of the n nodes (a sweep: every
    tensor (G * n, ...), copy g mixed by ``W[g]``).

    ``tree`` and ``ef`` are node-stacked flat dicts (``ef`` mirrors
    ``tree``, or is None when ``cfg.error_feedback`` is off); ``t`` is the
    step counter (an int) keying the stochastic rounding.  Returns
    ``(mixed, ef)``; non-float tensors pass through untouched.  Each
    reference leaf (:func:`reference_leaves`) of each copy is one record,
    quantized once from row offset 0, so the kernel sees the reference's
    stacked row counts and each copy's payload is its single run's bit
    for bit; a bucket of records is quantized in one call (see the
    module's docstring), then each record's residual is written, and its
    payload decoded and mixed, record by record.

    Unlike the reference, the residual is written into ``ef``'s tensors
    in place and ``ef`` itself is returned: at full width the old and the
    new residual (f32, twice the bf16 parameters each) would not fit on
    the card together.  A bucket's f32 temporaries are alive together:
    the chunk rows of x and err, then the residuals beside them and the
    payloads (1 byte per element for int8 and fp8), at most about 3.25 x
    :data:`BUCKET_BYTES` for a bucket within the cap; a leaf past the cap
    (the embedding; at n = 3 the MLP leaves too) is alone in its bucket
    and holds what it would hold quantized leaf by leaf."""
    trace.mark("mix")
    codec = get_codec(cfg.codec)
    key = sr_key(cfg.seed, t)
    Wf = W.float()
    Wcs = [Wf] if Wf.ndim == 2 else list(Wf)
    n = Wf.shape[-1]
    ds = [torch.diagonal(w) for w in Wcs]
    Woffs = [w - torch.diag(d) for w, d in zip(Wcs, ds)]
    out, records = {}, []
    for names in reference_leaves(tree):
        if tree[names[0]].is_floating_point():
            records += [(names, g) for g in range(len(Wcs))]
        else:
            out.update((k, tree[k]) for k in names)

    def rows_of(src, names, g):
        return group_to_rows([src[k][g * n:(g + 1) * n] for k in names],
                             cfg.chunk)

    cap = BUCKET_BYTES if codec.compress_many is not None else 0
    sizes = [rows_bytes([tree[k][:n] for k in names], cfg.chunk)
             for names, _ in records]
    for bucket in plan_buckets(sizes, cap):
        group = [records[i] for i in bucket]
        x2ds = [rows_of(tree, names, g) for names, g in group]
        e2ds = None if ef is None else [rows_of(ef, names, g)
                                        for names, g in group]
        payloads, resids = compress_bucket(codec, cfg, x2ds, e2ds, key,
                                           [0] * len(group))
        del x2ds, e2ds
        for names, g in group:
            sl = slice(g * n, (g + 1) * n)
            xs = [tree[k][sl] for k in names]
            shape = xs[0].shape
            resid = resids.pop(0)
            if ef is not None:
                for k, r in zip(names, rows_to_group(resid, shape,
                                                     len(names))):
                    ef[k][sl].copy_(r)
                del r   # the last view would keep the residual rows alive
            del resid
            hats = rows_to_group(codec.decode(cfg, payloads.pop(0)), shape,
                                 len(names))
            for k, x in zip(names, xs):
                hat = hats.pop(0)   # the last view frees the decoded rows
                mixed = torch.tensordot(Woffs[g], hat, dims=([1], [0]))
                del hat
                self_term = x.to(torch.float32, copy=True)
                self_term *= ds[g].reshape((-1,) + (1,) * (x.ndim - 1))
                mixed += self_term
                del self_term
                if k not in out:    # allocated as late as a run needs it
                    out[k] = torch.empty_like(tree[k])
                out[k][sl].copy_(mixed)
                del mixed
    return {k: out[k] for k in tree}, ef


def init_ef(params: dict, cfg: CompressionConfig | None) -> dict | None:
    """Zero f32 EF21 residuals mirroring the float tensors of ``params``
    (None when compression is off or error feedback is disabled)."""
    if cfg is None or not cfg.error_feedback:
        return None
    return {k: (torch.zeros_like(x, dtype=torch.float32)
                if x.is_floating_point() else x)
            for k, x in params.items()}
