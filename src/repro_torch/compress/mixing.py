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

The port's flat dict holds one tensor per block where the reference
stacks the blocks into one leaf, so a block's tensor is chunked, padded
and indexed on its own: the payload of the same flat dict is the
reference's bit for bit, the payload of the reference's stacked pytree
is not.
"""
from __future__ import annotations

import torch

from repro_torch import trace
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
    n = x.shape[0]
    flat = x.reshape(n, -1)
    p = flat.shape[1]
    rows = max(1, -(-p // chunk))
    if rows * chunk == p:
        return flat.to(torch.float32).reshape(n * rows, chunk)
    out = torch.zeros((n, rows * chunk), dtype=torch.float32,
                      device=x.device)
    out[:, :p] = flat
    return out.reshape(n * rows, chunk)


def rows_to_leaf(r2d: torch.Tensor, shape) -> torch.Tensor:
    """Inverse of :func:`leaf_to_rows` (f32)."""
    n = shape[0]
    p = 1
    for d in shape[1:]:
        p *= d
    return r2d.reshape(n, -1)[:, :p].reshape(shape)


def compressed_dense_mix(W: torch.Tensor, tree: dict, ef: dict | None,
                         cfg: CompressionConfig, t: int):
    """One compressed gossip round against a dense (n, n) mixing matrix.

    ``tree`` and ``ef`` are node-stacked flat dicts (``ef`` mirrors
    ``tree``, or is None when ``cfg.error_feedback`` is off); ``t`` is the
    step counter (an int) keying the stochastic rounding.  Returns
    ``(mixed, ef)``; non-float tensors pass through untouched.

    Unlike the reference, the residual is written into ``ef``'s tensors
    in place and ``ef`` itself is returned: at full width the old and the
    new residual (f32, twice the bf16 parameters each) would not fit on
    the card together.  One tensor's f32 temporaries are alive at a
    time."""
    trace.mark("mix")
    codec = get_codec(cfg.codec)
    key = sr_key(cfg.seed, t)
    Wf = W.float()
    d = torch.diagonal(Wf)
    Woff = Wf - torch.diag(d)
    out = {}
    for k, x in tree.items():
        if not x.is_floating_point():
            out[k] = x
            continue
        e = None if ef is None else ef[k]
        x2d = leaf_to_rows(x, cfg.chunk)
        e2d = None if e is None else leaf_to_rows(e, cfg.chunk)
        payload, resid = codec.compress(cfg, x2d, e2d, key, 0)
        del x2d, e2d
        if e is not None:
            e.copy_(rows_to_leaf(resid, e.shape))
        del resid
        hat = rows_to_leaf(codec.decode(cfg, payload), x.shape)
        del payload
        mixed = torch.tensordot(Woff, hat, dims=([1], [0]))
        del hat
        self_term = x.to(torch.float32, copy=True)
        self_term *= d.reshape((-1,) + (1,) * (x.ndim - 1))
        mixed += self_term
        del self_term
        out[k] = mixed.to(x.dtype)
        del mixed
    return out, ef


def init_ef(params: dict, cfg: CompressionConfig | None) -> dict | None:
    """Zero f32 EF21 residuals mirroring the float tensors of ``params``
    (None when compression is off or error feedback is disabled)."""
    if cfg is None or not cfg.error_feedback:
        return None
    return {k: (torch.zeros_like(x, dtype=torch.float32)
                if x.is_floating_point() else x)
            for k, x in params.items()}
