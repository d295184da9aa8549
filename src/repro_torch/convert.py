"""Carry the reference's parameters (and method state) into the port.

The JAX model's params are a pytree of dicts and lists whose paths are
the port's ``state_dict`` keys, with one difference: the repeated pattern
blocks are stacked in the reference (``stack.blocks[i]`` leaves carry a
leading ``num_blocks`` axis, ``blocks.py:146-160``) and are one module
per block here (``stack.blocks.<block>.<i>``).  Every leaf under the
blocks is split the same way, a projection's bias (``….attn.wq.b``,
qwen's QKV biases) as its weight, a Mamba layer's leaves
(``….mamba.in_proj.w``, ``conv_w``, ``conv_b``, ``A_log``, ``D``,
``dt_bias``, ``norm.scale``, ``out_proj.w``) and a decoder layer's
cross-attention leaves (``….ln_x.scale``, ``….cross.w{q,k,v,o}.w``) as
any other.  An encoder-decoder's encoder stack
(``encoder.stack.blocks.<block>.0.…``, and ``encoder.final_norm.scale``)
is split the same way as the decoder's.  Weight
orientation is the same on both sides, so each leaf is a copy.  Paged
KV caches (page pools) cross the same way, in both directions
(:func:`paged_cache_from_jax`, :func:`paged_cache_to_numpy`).  The way
back, :func:`tree_to_jax`, stacks the blocks again (:func:`jax_leaves`
names each of the reference's leaves and the port keys it stacks); the
checkpoint engine writes the reference's keys and shapes through it.  The
distributed runtime holds one node per rank: :func:`rank_slice` cuts
rank r's ``(1, ...)`` slice out of a node-stacked tree or method state,
and :func:`stack_ranks` puts the ranks' slices back together.  A
tensor-parallel rank holds its shard of each tensor under a table of
specs (``dist.sharding``): :func:`shard_for_rank` cuts it out of a full
flat dict, and :func:`unshard_ranks` puts the ranks' shards back
together.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from repro_torch.configs.common import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import entry_axes
from repro_torch.launch.mesh import rank_coords
from repro_torch.models.model import Model

_BLOCKS = re.compile(r"^(.*?\bstack\.blocks)\.(\d+)\.(.*)$")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)                    # a writable copy
    if a.dtype.name == "bfloat16":     # ml_dtypes' bf16: carry the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def tree_from_jax(tree, *, node_axis: bool = False) -> dict:
    """A flat dict of CPU tensors from a reference pytree of numpy leaves
    — model params, an MLP's params, or a method's state tree (``u``,
    ``m``, ``y``, ...).  Keys are the tree paths joined by dots; a leaf
    under ``stack.blocks.<pos>`` is split along its ``num_blocks`` axis
    into ``stack.blocks.<block>.<pos>.…``.  With ``node_axis=True`` the
    leaves are node-stacked, ``(n, num_blocks, …)`` under the blocks, and
    the split takes axis 1."""
    axis = 1 if node_axis else 0
    out = {}
    for name, arr in _leaves(tree):
        m = _BLOCKS.match(name)
        if m is None:
            out[name] = _to_torch(arr)
            continue
        head, pos, rest = m.groups()
        for b in range(arr.shape[axis]):
            out[f"{head}.{b}.{pos}.{rest}"] = _to_torch(
                np.take(arr, b, axis=axis))
    return out


def jax_leaves(keys) -> list[tuple[str, list[str], bool]]:
    """The reference's leaves of a flat dict's keys, in the order first
    met: each leaf's tree path joined by dots, the port keys it holds
    (a pattern block's tensors in block order) and whether they are
    stacked along a ``num_blocks`` axis.  ``stack.blocks.<b>.<pos>.…``
    becomes the path ``stack.blocks.<pos>.…``; any other key is a leaf of
    its own."""
    leaves: dict[str, dict] = {}
    for k in keys:
        m = _BLOCKS.match(k)
        path = k if m is None else f"{m[1]}.{m[3]}"
        leaves.setdefault(path, {})[0 if m is None else int(m[2])] = k
    out = []
    for path, blocks in leaves.items():
        stacked = _BLOCKS.match(blocks[min(blocks)]) is not None
        if stacked and sorted(blocks) != list(range(len(blocks))):
            raise ValueError(f"{path}: blocks {sorted(blocks)} are not "
                             f"0..{len(blocks) - 1}")
        out.append((path, [blocks[b] for b in sorted(blocks)], stacked))
    return out


#: the float dtypes numpy has no name for, and the int type of their width
BIT_VIEWS = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8,
             torch.float8_e5m2: torch.uint8}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU copy of ``t``; bf16 and fp8 as their bits, a same-width
    unsigned int (numpy has no such dtype without ``ml_dtypes``)."""
    t = t.detach().cpu()
    if t.dtype in BIT_VIEWS:
        return t.view(BIT_VIEWS[t.dtype]).numpy().view(
            np.dtype(f"u{t.element_size()}"))
    return t.numpy()


def tree_to_jax(flat: dict, *, node_axis: bool = False) -> dict:
    """The inverse of :func:`tree_from_jax`: the reference's pytree of
    numpy arrays from a flat dict of tensors (dicts, and lists where a
    path's part is an index).  The pattern blocks are stacked back along
    their ``num_blocks`` axis (axis 1 with ``node_axis=True``, after the
    node axis; else 0).  bf16 and fp8 leaves come back as their bits
    (uint16, uint8): view them as ``ml_dtypes``' types where it is at
    hand."""
    axis = 1 if node_axis else 0
    tree: dict = {}
    for path, keys, stacked in jax_leaves(flat):
        arr = (np.stack([_to_numpy(flat[k]) for k in keys], axis=axis)
               if stacked else _to_numpy(flat[keys[0]]))
        node = tree
        parts = path.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr
    return _lists(tree)


def _lists(tree):
    """Dicts whose keys are all indices 0..k-1 as lists, as the
    reference's layer lists are."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _lists(v) for k, v in tree.items()}
    if out and all(k.isdigit() for k in out) \
            and sorted(map(int, out)) == list(range(len(out))):
        return [out[str(i)] for i in range(len(out))]
    return out


def state_from_jax(state: dict) -> dict:
    """A decentralized method's node-stacked state from the reference, in
    the port's form: each tree (``u``, ``m``, ``ef``, ...) a flat dict of
    CPU tensors (:func:`tree_from_jax` with ``node_axis=True``), and the
    0-d step counter ``ct`` of a compressed method a host int."""
    return {k: (tree_from_jax(v, node_axis=True)
                if isinstance(v, (dict, list, tuple)) else int(np.asarray(v)))
            for k, v in state.items()}


def params_from_jax(tree, cfg: ArchConfig, *, device=None,
                    dtype=torch.float32) -> Model:
    """A :class:`Model` holding the reference's parameter pytree ``tree``
    (leaves as numpy arrays), cast to ``dtype`` on ``device``.  A tree
    with another block count than ``cfg`` fails the strict load."""
    model = Model(cfg, dtype=dtype, device=resolve_device(device))
    model.load_state_dict(tree_from_jax(tree), strict=True)
    return model.eval()


def paged_cache_from_jax(tree, *, device=None) -> dict:
    """The port's page pools from the reference's (``init_paged_cache``,
    ``model.py:201``): ``{"prologue": [{"attn": {"k", "v"}}], "blocks":
    [[...] per block]}`` of ``(P, ps, KV, hd)`` tensors, the reference's
    stacked ``(num_blocks, P, ps, KV, hd)`` leaves split by block."""
    dev = resolve_device(device)

    def layer(c, b=None):
        return {"attn": {n: _to_torch(np.asarray(c["attn"][n]) if b is None
                                      else np.asarray(c["attn"][n])[b])
                         .to(dev) for n in ("k", "v")}}

    nb = np.asarray(tree["blocks"][0]["attn"]["k"]).shape[0] \
        if tree["blocks"] else 0
    return {"prologue": [layer(c) for c in tree["prologue"]],
            "blocks": [[layer(c, b) for c in tree["blocks"]]
                       for b in range(nb)]}


def paged_cache_to_numpy(pools: dict) -> dict:
    """The inverse of :func:`paged_cache_from_jax`: the reference's pool
    tree of numpy arrays (f32; the blocks stacked per pattern position)."""
    def arr(t):
        return t.detach().float().cpu().numpy()

    blocks = pools["blocks"]
    return {"prologue": [{"attn": {n: arr(c["attn"][n]) for n in ("k", "v")}}
                         for c in pools["prologue"]],
            "blocks": [{"attn": {n: np.stack([arr(blk[i]["attn"][n])
                                              for blk in blocks])
                                 for n in ("k", "v")}}
                       for i in range(len(blocks[0]) if blocks else 0)]}


def rank_slice(tree, r: int):
    """Rank r's slice of a node-stacked flat dict, or of a method state (a
    dict of such dicts, with a compressed method's host-int ``ct``): every
    tensor ``x`` becomes the view ``x[r:r+1]``, with its node axis of size
    1, the shape a rank of the distributed runtime holds.  Anything else
    (an int, None) passes through."""
    if isinstance(tree, dict):
        return {k: rank_slice(v, r) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree[r:r + 1]
    return tree


def stack_ranks(slices):
    """The inverse of :func:`rank_slice`: the ranks' ``(1, ...)`` slices,
    in rank order, concatenated along the node axis (on the CPU).  An int
    such as ``ct`` must be the same on every rank."""
    first = slices[0]
    if isinstance(first, dict):
        return {k: stack_ranks([s[k] for s in slices]) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.cat([s.detach().cpu() for s in slices])
    if any(s != first for s in slices[1:]):
        raise ValueError(f"ranks disagree: {slices}")
    return first


def _shard_index(shape, spec, mesh, coords) -> tuple:
    """The slices of a ``shape`` tensor that the rank at ``coords`` holds
    under ``spec``: on each sharded dim, ``1/size`` of it at the offset
    of the rank's row-major coordinate over the entry's axes."""
    index = []
    for dim, entry in zip(shape, spec):
        pos, size = 0, 1
        for a in entry_axes(entry):
            pos, size = pos * mesh.shape[a] + coords[a], size * mesh.shape[a]
        width = dim // size
        index.append(slice(pos * width, (pos + 1) * width))
    return tuple(index)


def shard_for_rank(flat: dict, specs: dict, mesh, coords: dict) -> dict:
    """The rank at ``coords`` on ``mesh``: its shard of each tensor of the
    full flat dict ``flat`` under ``specs`` (same keys), a copy where the
    spec shards it and the tensor itself where it is replicated.  Empties
    ``flat`` as it goes: each full tensor is dropped once its shard is
    cut, so the peak is the full dict and one shard (pass ``dict(flat)``
    to keep the caller's)."""
    out = {}
    for key in list(flat):
        t, spec = flat.pop(key), specs[key]
        if any(e is not None for e in spec):
            t = t[_shard_index(t.shape, spec, mesh, coords)].clone()
        out[key] = t
    return out


def unshard_ranks(shards: list, specs: dict, mesh) -> dict:
    """The inverse of :func:`shard_for_rank`: the full flat dict (on the
    CPU) from every rank's shards, rank r at ``launch.mesh.rank_coords``.
    Ranks that hold the same slice must hold the same bits."""
    out = {}
    for key, spec in specs.items():
        pieces = [s[key].detach().cpu() for s in shards]
        shape = list(pieces[0].shape)
        for i, entry in enumerate(spec):
            for a in entry_axes(entry):
                shape[i] *= mesh.shape[a]
        full = torch.empty(shape, dtype=pieces[0].dtype)
        seen = {}
        for r, piece in enumerate(pieces):
            idx = _shard_index(shape, spec, mesh, rank_coords(mesh, r))
            at = tuple((i.start, i.stop) for i in idx)
            if at in seen:
                if not torch.equal(seen[at], piece):
                    raise ValueError(f"{key}: ranks holding {at} differ")
                continue
            seen[at] = piece
            full[idx] = piece
        out[key] = full
    return out
