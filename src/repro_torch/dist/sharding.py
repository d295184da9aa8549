"""Sharding rules: which mesh axes host the gossip nodes and which shard
the weights, for every (arch, mesh, context) combination (port of
``repro/dist/sharding.py``).

Two mesh families (:mod:`repro_torch.launch.mesh`):

  * single pod   (16, 16)      axes ("data", "model")
  * multi-pod    (2, 16, 16)   axes ("pod", "data", "model")

Small archs train with the gossip nodes on "data" and tensor parallelism
on "model"; a multi-pod mesh adds plain data parallelism over "pod".  The
archs of ``POD_GOSSIP_ARCHS`` need both in-pod axes for the weights (2-D
sharding: contraction dim on "data", output dim on "model"), so their
gossip moves to the "pod" axis; on a single pod that degenerates to
1-node gossip with the batch sharded over "data".

A spec is a tuple with one entry per dim of its tensor: None
(replicated), an axis name, or a tuple of axis names, the entries of a
``PartitionSpec``.  The specs are tables over the port's trees: a flat
dict of parameters keyed by ``state_dict`` keys, a batch dict, a cache
tree of dicts and lists.  The reference stacks each pattern position's
blocks along a leading dim, which its specs replicate; the port keeps one
tensor per block (``stack.blocks.<block>.<position>.…``), so that entry
has no counterpart here.

Rules are pure functions of ``mesh.shape`` / ``mesh.axis_names``, so any
object with those two drives them (tests use a fake mesh and no ranks).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

# Architectures whose bf16 weights exceed a single pod's memory: weights
# take both in-pod axes, gossip happens across pods.
POD_GOSSIP_ARCHS = ("grok-1-314b", "jamba-1.5-large-398b",
                    "deepseek-v3-671b")


@dataclass(frozen=True)
class ShardingRules:
    """mesh + axis roles.  ``tp`` shards weight matrices, ``dp`` shards
    the within-node batch dim, ``node_axis`` hosts the gossip nodes
    (None = degenerate single-node gossip)."""
    mesh: Any
    tp: tuple[str, ...]
    dp: tuple[str, ...]
    node_axis: str | None

    def axis_size(self, axes: tuple[str, ...]) -> int:
        size = 1
        for a in axes:
            size *= self.mesh.shape[a]
        return size

    def divides(self, dim: int, axes: tuple[str, ...]) -> bool:
        """True iff ``dim`` splits evenly over the named mesh axes, the
        guard before any spec entry; indivisible dims stay replicated."""
        return dim % self.axis_size(axes) == 0

    @property
    def n_nodes(self) -> int:
        if self.node_axis is None:
            return 1
        return self.mesh.shape[self.node_axis]


def make_rules(mesh, *, arch_name: str, context: str) -> ShardingRules:
    """Axis roles for ``arch_name`` on ``mesh`` in context "train" or
    "serve"."""
    if context not in ("train", "serve"):
        raise ValueError(f"unknown context {context!r}")
    multi = "pod" in tuple(mesh.axis_names)
    big = arch_name in POD_GOSSIP_ARCHS

    if context == "train":
        if big:
            # multi-pod: gossip over "pod"; single pod: degenerate 1-node
            # gossip, the batch sharded over "data" beside the 2-D weights
            return ShardingRules(mesh, ("data", "model"), ("data",),
                                 "pod" if multi else None)
        return ShardingRules(mesh, ("model",), ("pod",) if multi else (),
                             "data")

    # serve: no gossip nodes; batch over every non-weight axis.
    if big:
        return ShardingRules(mesh, ("data", "model"),
                             ("pod",) if multi else (), None)
    return ShardingRules(mesh, ("model",),
                         ("pod", "data") if multi else ("data",), None)


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """The shape of one rank's shard of a ``shape`` tensor laid out by
    ``spec``: each dim divided by the size of its entry's axes."""
    out = []
    for dim, entry in zip(shape, spec):
        size = 1
        for a in entry_axes(entry):
            size *= mesh.shape[a]
        out.append(dim // size)
    return tuple(out) + tuple(shape[len(spec):])


def _map(fn, tree, path=""):
    """``fn(path, leaf)`` over a tree of dicts and lists (a flat dict is
    one level), keeping its structure; ``path`` joins the keys by dots."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{path}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v, f"{path}{i}.") for i, v in enumerate(tree)]
    return fn(path[:-1], tree)


def param_partition_specs(params, rules: ShardingRules,
                          node_axis: bool = False) -> dict:
    """The spec of each tensor of a flat parameter (or optimizer-state)
    dict, keyed as ``params``.

    After peeling the optional leading node-stack dim (on
    ``rules.node_axis``):

      * matrices (>= 2 remaining dims): last dim on ``tp[-1]``
        ("model"); with a 2-axis ``tp`` also the contraction dim on
        ``tp[0]`` ("data"), the 2-D rule;
      * vectors and scalars (norm scales, biases): replicated.

    A split that does not divide evenly stays replicated."""
    tp = rules.tp

    def spec_for(path, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            # rank-0 leaves (a step counter) have no dim for the node axis
            return ()
        lead = [rules.node_axis] if node_axis else []
        weight = shape[len(lead):]
        sub: list = [None] * len(weight)
        if len(weight) >= 2:
            if rules.divides(weight[-1], (tp[-1],)):
                sub[-1] = tp[-1]
            if len(tp) == 2 and rules.divides(weight[-2], (tp[0],)):
                sub[-2] = tp[0]
        return tuple(lead + sub)

    return _map(spec_for, params)


def dp_entry(rules: ShardingRules, batch: int | None = None):
    """The spec entry of a batch dim of ``batch`` rows: ``dp`` (one axis
    as its name, as a ``PartitionSpec`` writes it), or None when ``dp``
    is empty or does not divide the batch, which then stays whole on
    every rank (``steps.py:50-57``)."""
    if not rules.dp:
        return None
    if batch is not None and not rules.divides(batch, rules.dp):
        return None
    return rules.dp[0] if len(rules.dp) == 1 else tuple(rules.dp)


def batch_partition_specs(batch, rules: ShardingRules, *,
                          node_stacked: bool = True) -> dict:
    """Input-batch specs.  Node-stacked train batches are (n, b, ...):
    node dim on ``node_axis``, per-node batch dim on ``dp``.  Serve
    batches are (B, ...): batch dim on ``dp``.  A batch dim that does not
    divide over ``dp`` stays replicated."""
    def spec_for(path, leaf):
        nd = len(leaf.shape)
        bdim = 1 if node_stacked else 0
        entry = dp_entry(rules, leaf.shape[bdim]) if nd > bdim else None
        lead = ([rules.node_axis, entry] if node_stacked else [entry])[:nd]
        return tuple(lead + [None] * (nd - len(lead)))

    return _map(spec_for, batch)


def cache_partition_specs(cache, rules: ShardingRules):
    """KV / SSM cache specs, the cache's tree structure with a spec per
    tensor: the batch dim (the first) on ``dp``, everything else
    replicated."""
    def spec_for(path, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return ()
        return (dp_entry(rules, shape[0]),) + (None,) * (len(shape) - 1)

    return _map(spec_for, cache)
