"""This rank's decentralized train step (the port of
``repro/dist/steps.py``).

The reference's step is one ``pjit`` over the node-stacked tree, sharded
over the mesh's node axis.  Here each rank of a ``torch.distributed``
group is one node and holds that node's flat dict, every tensor with a
leading node axis of size 1.  A step computes this node's loss and
gradients (``models.model.loss_fn``, through the simulation engine's
``node_grads``), then the method's update with a mixer that runs the
compiled slot plan's round ``step % len(plan)`` over the group
(``repro_torch.dist.gossip``) instead of the dense ``W(r) @ X``.
Numerics match the simulation engine up to the f32 summation order of the
combine (``tests/test_torch_dist.py`` is the oracle).

As the reference's, the step checkpoints each pattern block by default
(``remat=True``, ``steps.py:88``): the backward recomputes a block's
forward in place of keeping its activations, which the wider models need
to train.

``overlap=True`` runs the update and the gossip group by group
(:func:`overlap_groups`), each group's exchange issued as soon as its
inputs to the mix are final and waited on only at its combine, so the
wire carries one group while the card and the host work on the next;
the result is the sequential step's bit for bit (see
:func:`make_train_step`).

Over a live mesh (``make_train_step(cfg, mesh=)``, the reference's
``steps.py:84-265``) a node spans the ranks that share its coordinate
on the train rules' node axis (``dist.sharding.make_rules(context=
"train")``): each rank holds its shard of every tensor of its node (cut
by ``convert.shard_for_rank``, node axis of size 1) and the method state
of those shards, computes its gradients through a model bound to them
(``dist.tp``: autograd through the collectives, the batch rows split
over the rules' ``dp`` where they divide), applies the method's update,
which is per tensor and unchanged, and gossips its shards with the
ranks of the other nodes that hold the same slices
(``mesh.group(rules.node_axis)``, the same slot plan).  Under the 2-D
rule on one pod there is one node and no gossip.

Serving runs over a live ``(data, model)`` mesh
(:func:`make_prefill`, :func:`make_decode_step`, the reference's
``steps.py:268-353``): each rank holds its shard of every tensor under
the serve rules (``dist.sharding``, cut by ``convert.shard_for_rank``)
and its rows of the batch, and the model bound to the shards
(``dist.tp.bind``) runs the collectives in its layers.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch import trace
from repro_torch.compress import CompressionConfig
from repro_torch.compress import resolve as resolve_compression
from repro_torch.convert import _BLOCKS
from repro_torch.core.ppermute_plan import SchedulePlan
from repro_torch.models import model as M
from repro_torch.optim.decentralized import Method, make_method
from repro_torch.sim.engine import _map, node_grads
from repro_torch.topology import (Schedule, TopologySpec, as_schedule,
                                  spec_from_cli)

from .gossip import make_gossip_mixer
from .sharding import ShardingRules, dp_entry, entry_axes, make_rules
from .tp import bind, rows_share_keys

#: groups of the overlapped step whose exchanges are in flight at once at
#: most: a group's exchange is waited on once the next group's is issued
OVERLAP_WINDOW = 2


@dataclass(frozen=True)
class TrainStepBundle:
    step_fn: Callable           # (params_1, opt, batch_1, step)
    n_rounds: int
    plan: SchedulePlan
    spec: TopologySpec | None
    # resolved gossip-payload compression (None = uncompressed)
    compression: CompressionConfig | None
    # the Method the step runs: callers init the optimizer state from
    # THIS object (its state tree depends on the compression)
    method: Method
    # the gossip mixer; ``mixer.stats`` counts the messages and bytes
    # this rank sent
    mixer: Any
    # the update and gossip run group by group (``overlap_groups``)
    overlap: bool = False
    # (params_1, batch_1) -> (this node's loss, this rank's gradients):
    # the step's first half
    grad_fn: Callable | None = None
    # over a mesh: the train rules, and the marked skeleton the forward
    # runs through (``model.tp.stats`` counts its gathers)
    rules: ShardingRules | None = None
    model: Any = None
    n_nodes: int = 1
    node: int = 0               # this rank's node


def overlap_groups(keys) -> list[list[str]]:
    """The overlapped step's groups of a flat dict's keys: each pattern
    block (``stack.blocks.<b>``, an encoder's too) is a group, and every
    other key goes with its first part (``embed``, ``stack`` (the
    prologue), ``final_norm``, ``lm_head``, ``mtp``, ``encoder``).  The
    groups come output end first, the reverse of the model's order, which
    is the order the backward finishes them in."""
    groups: dict[str, list] = {}
    for k in keys:
        m = _BLOCKS.match(k)
        groups.setdefault(f"{m[1]}.{m[2]}" if m else k.split(".", 1)[0],
                          []).append(k)
    return list(groups.values())[::-1]


def _overlapped_update(method: Method, params: dict, grads: dict,
                       opt: dict, mixer, step: int, eta: float,
                       groups: list) -> tuple[dict, dict]:
    """``method.step`` with ``mixer``, run group by group: each group's
    ``mix_steps`` generator computes its tree to mix, whose exchange is
    issued at once (``mixer.issue``); once :data:`OVERLAP_WINDOW` groups
    are in flight the oldest is completed (``mixer.complete``), which
    bounds the buffers held to that many groups'.  A second mix of a
    group (gradient tracking) is issued when its first completes, so a
    group's mixes keep their order, and every rank issues the same
    exchanges in the same order."""
    running: deque = deque()
    new_p, new_s = {}, {sk: {} for sk in opt}

    def finish(steps, handle):
        try:
            tree = steps.send(mixer.complete(handle))
        except StopIteration as stop:
            p_g, s_g = stop.value
            new_p.update(p_g)
            for sk, sv in s_g.items():
                new_s[sk].update(sv)
            return
        running.append((steps, mixer.issue(tree, step)))

    for keys in groups:
        steps = method.mix_steps({k: params[k] for k in keys},
                                 {k: grads[k] for k in keys},
                                 {sk: {k: sv[k] for k in keys}
                                  for sk, sv in opt.items()}, eta)
        running.append((steps, mixer.issue(next(steps), step)))
        while len(running) >= OVERLAP_WINDOW:
            finish(*running.popleft())
    while running:
        finish(*running.popleft())
    return ({k: new_p[k] for k in params},
            {sk: {k: sv[k] for k in params} for sk, sv in new_s.items()})


def make_train_step(cfg, group=None, *, mesh=None,
                    topology: str | TopologySpec | Schedule = "base",
                    k: int = 1, method_name: str = "dsgdm",
                    eta: float = 0.01, param_dtype=torch.bfloat16,
                    remat: bool = True, momentum: float = 0.9,
                    flatten_gossip: bool = False, compression=None,
                    overlap: bool = False,
                    embed_lookup_replicated: bool = False
                    ) -> TrainStepBundle:
    """One DSGD-family step of this rank's node: its gradients -> the
    method update -> gossip round ``step % n_rounds`` over ``group``
    (None: the default group; its size is the node count), or over the
    node axis of the live ``mesh`` (:func:`_sharded_grads`; give one of
    the two).

    ``topology`` is a registered name (with ``k``), an inline JSON spec
    string, a ``TopologySpec`` (its ``n`` must match the node count) or
    a prebuilt ``Schedule``.  ``compression`` (a ``CompressionConfig``,
    a CLI string such as ``"int8"``, or None) turns the gossip into
    quantized, error-feedback payload exchange; the EF residuals and the
    step counter ride in the method's state.  ``remat`` checkpoints each
    pattern block of the forward (``models.model.loss_fn``).

    ``bundle.step_fn(params_1, opt, batch_1, step)`` takes this node's
    flat dict of ``param_dtype`` float tensors (node axis of size 1;
    over a mesh, this rank's shards of them), the method state, this
    node's batch (``{"tokens", "labels"}``, leading axis of size 1) and
    the step index, and returns the new parameters, the new state and
    this node's loss (a 0-d tensor).

    ``overlap=True`` (the reference's ``steps.py:110-124``): the
    parameters and the method state split along :func:`overlap_groups`,
    each pattern block a group (the reference's stack is one scan op and
    one group; here each block is a module of its own), and each group
    runs its own update and gossip chain (``_overlapped_update``): its
    exchange is issued as soon as its update is, and waited on only once
    the next group's is in flight.  The update and the mixing are per
    tensor, so parameters, state and losses equal the sequential step's
    bit for bit, and the mixer sends the same messages and bytes (with
    ``flatten_gossip`` each group sends one flat buffer per slot, as the
    reference's per-group mixers do: the same bytes in more messages).
    The gradients are taken whole first: every point-to-point call stays
    on this thread, which the backward's dispatch holds until its last
    gradient, so the first exchange starts when the backward has been
    issued, and the wire carries a group while the update, staging and
    combine of the others run.  With ``compression`` it raises
    ``ValueError``, as the reference's does (``steps.py:138-142``); a
    one-node group has nothing to overlap and steps sequentially.

    ``embed_lookup_replicated`` (a mesh only, the reference's
    ``steps.py:209-223``): the embedding table is gathered whole over its
    sharded axes before the token lookup, one gather of the table in
    place of the lookup's partial rows; the result is the same."""
    ccfg = resolve_compression(compression)
    if ccfg is not None and overlap:
        raise ValueError(
            "overlap + compression is unsupported: the compressed "
            "method's scalar step counter cannot be split along the "
            "per-group overlap chains")
    rules = model = None
    if mesh is None:
        if embed_lookup_replicated:
            raise ValueError("embed_lookup_replicated lays the table out "
                             "over a mesh; this step holds whole nodes")
        n, node = dist.get_world_size(group), dist.get_rank(group)

        def loss_one(p, b):
            return M.loss_fn(cfg, p, b, remat=remat)[0]

        def grad_fn(params_1, batch):
            losses, grads = node_grads(loss_one, params_1, batch)
            return losses[0], grads
    else:
        if group is not None:
            raise ValueError("a train step takes a group or a mesh, not "
                             "both")
        rules = make_rules(mesh, arch_name=cfg.name, context="train")
        n = rules.n_nodes
        # a node axis of one rank gossips nothing: its group is None,
        # which must not become the default group
        group = mesh.group(rules.node_axis) if n > 1 else None
        node = mesh.coords[rules.node_axis] if n > 1 else 0
        model = bind(cfg, None, mesh, context="train")
        if embed_lookup_replicated and model.embed.tp is not None:
            model.embed.tp.lookup_whole = True
        grad_fn = _sharded_grads(cfg, rules, model, remat)
    overlap = overlap and n > 1
    if isinstance(topology, Schedule):
        if topology.n != n:
            raise ValueError(f"schedule built for n={topology.n} but the "
                             f"step has {n} nodes")
        sched = topology
    else:
        sched = as_schedule(spec_from_cli(topology, n=n, k=k))
    plan = sched.as_ppermute_plan()
    method = make_method(method_name, momentum, compression=ccfg)
    if mesh is not None and n == 1:
        mixer = _no_gossip(ccfg)
    else:
        mixer = make_gossip_mixer(group, plan, flatten=flatten_gossip,
                                  compression=ccfg)

    def step_fn(params_1, opt, batch, step):
        bad = {k: x.dtype for k, x in params_1.items()
               if x.is_floating_point() and x.dtype != param_dtype}
        if bad:
            raise TypeError(f"the step takes {param_dtype} parameters, got "
                            f"{bad}")
        dev = next(iter(params_1.values())).device
        batch = _map(lambda a: torch.as_tensor(a).to(dev), batch)
        trace.mark("step")
        loss, grads = grad_fn(params_1, batch)
        trace.mark("update")
        with torch.no_grad():
            if overlap:
                params_1, opt = _overlapped_update(
                    method, params_1, grads, opt, mixer, step, eta,
                    overlap_groups(params_1))
            elif ccfg is not None:
                params_1, opt = method.step(
                    params_1, grads, opt,
                    lambda tr, e, c: mixer(tr, step, e, c), eta)
            else:
                params_1, opt = method.step(
                    params_1, grads, opt, lambda t: mixer(t, step), eta)
        trace.mark("end")
        return params_1, opt, loss

    return TrainStepBundle(
        step_fn=step_fn, n_rounds=len(sched), plan=plan, spec=sched.spec,
        compression=ccfg, method=method, mixer=mixer, overlap=overlap,
        grad_fn=grad_fn, rules=rules, model=model, n_nodes=n, node=node)


def _no_gossip(ccfg):
    """The mixer of a one-node step over a mesh: the tree as it is (and
    the EF residuals, compressed), as the reference's degenerate gossip
    (``steps.py:176-183``); it sends nothing."""
    if ccfg is None:
        def mixer(tree, r):
            return tree
    else:
        def mixer(tree, r, ef, t):
            return tree, ef
    mixer.stats = {"messages": 0, "bytes": 0}
    return mixer


def _sharded_grads(cfg, rules: ShardingRules, model, remat: bool):
    """This rank's ``(loss, grads)`` of its node's batch over the mesh of
    ``rules``, through ``model``, the marked skeleton
    (``dist.tp.bind(cfg, None, mesh, context="train")``).

    The rank takes its rows of the node's batch (:func:`local_rows`: a
    share of them where the train rules' ``dp`` divides the rows, all of
    them otherwise) and names the axes that split them in
    ``model.tp.row_axes``.  ``models.model.loss_fn`` runs the sharded
    forward over its shards and returns the node's whole-batch loss on
    every rank (the summed losses and counts added over the row axes in
    rank order, not a mean of means).  The backward runs through the
    collectives (``dist.tp``): each shard's gradient is the gradient of
    its slice of the whole tensor, for the rank's rows.  The gradients
    are then added over the row axes in rank order where the backward
    left a share of the rank's rows (``dist.tp.rows_share_keys``), as the
    reference's step sums them over its batch-sharded axes."""
    comm = model.tp

    def grad_fn(params_1, batch):
        b = batch["tokens"].shape[1]
        comm.row_axes = entry_axes(dp_entry(rules, b))
        row0, rows = local_rows(rules, b)
        mine = _map(lambda a: a[0, row0:row0 + rows], batch)
        p = {k: x[0].detach().requires_grad_() for k, x in params_1.items()}
        loss = M.loss_fn(cfg, p, mine, remat=remat, model=model)[0]
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        if comm.row_axes:
            for k in rows_share_keys(model):
                grads[k] = comm.sum_rows(grads[k], grad=False)
        # a gradient a gather's backward sliced is a view; the update
        # takes contiguous tensors
        return loss.detach(), {k: g.contiguous()[None]
                               for k, g in grads.items()}

    return grad_fn


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PrefillBundle:
    # (params, batch) -> (last-position logits, caches, enc_out | None)
    fn: Callable
    rules: ShardingRules
    seq: int


@dataclass(frozen=True)
class DecodeBundle:
    # (params, caches, tokens, index[, enc_out]) -> (logits, caches)
    fn: Callable
    rules: ShardingRules
    seq: int
    decode_mode: str = "dus"


def local_rows(rules: ShardingRules, batch: int) -> tuple[int, int]:
    """``(first, count)``: the rows of a ``batch``-row serve batch this
    rank holds (all of them when the batch stays whole)."""
    axes = entry_axes(dp_entry(rules, batch))
    pos = 0
    for a in axes:
        pos = pos * rules.mesh.shape[a] + rules.mesh.coords[a]
    rows = batch // rules.axis_size(axes)
    return pos * rows, rows


def bound_model(cfg, mesh, params) -> M.Model:
    """``params`` as a model bound to this rank's shards: a flat dict of
    shards is bound (``dist.tp.bind``); a model that ``bind`` returned
    for ``mesh`` passes through."""
    if isinstance(params, M.Model):
        if getattr(params, "tp", None) is None \
                or params.tp.mesh is not mesh:
            raise ValueError("a sharded step takes this rank's shard dict, "
                             "or the model dist.tp.bind made of it on the "
                             "same mesh")
        return params
    return bind(cfg, params, mesh)


def _serve_checks(rows, param_dtype, model, tokens):
    if tokens.shape[0] != rows:
        raise ValueError(f"this rank holds {rows} rows of the batch, got "
                         f"{tokens.shape[0]}")
    if model.embed.table.dtype != param_dtype:
        raise TypeError(f"built for {param_dtype} parameters, got "
                        f"{model.embed.table.dtype}")


def make_prefill(cfg, mesh, *, batch: int, seq: int,
                 param_dtype=torch.bfloat16,
                 cache_dtype=torch.bfloat16) -> PrefillBundle:
    """Prompt -> (last-position logits, a fresh cache of ``seq``
    positions, the encoder output or None), on this rank of the live
    ``mesh``.  ``bundle.fn(params, batch)`` takes this rank's shard dict
    (or the model ``dist.tp.bind`` made of it) and its rows of the
    ``batch``-row serve batch (:func:`local_rows`)."""
    rules = make_rules(mesh, arch_name=cfg.name, context="serve")
    rows = local_rows(rules, batch)[1]

    def fn(params, b):
        model = bound_model(cfg, mesh, params)
        _serve_checks(rows, param_dtype, model, b["tokens"])
        logits, caches = M.prefill(cfg, model, b, seq, cache_dtype)
        return logits, caches, caches.pop("enc_out", None)

    return PrefillBundle(fn=fn, rules=rules, seq=seq)


def make_decode_step(cfg, mesh, *, batch: int, seq: int,
                     param_dtype=torch.bfloat16,
                     append_free: bool = False) -> DecodeBundle:
    """One decode step against this rank's cache (the batch rows of
    :func:`local_rows`, every position), in the explicit
    ``decode_mode`` the bundle records (``"append_free"`` writes
    nothing).  ``bundle.fn(params, caches, tokens, index)`` returns
    ``(logits, caches)``, the caches updated in place; an encoder
    model's takes the encoder output from prefill as a fifth argument,
    as the reference's (``steps.py:344-347``)."""
    rules = make_rules(mesh, arch_name=cfg.name, context="serve")
    rows = local_rows(rules, batch)[1]
    mode = "append_free" if append_free else "dus"

    def run(params, caches, tokens, index, enc_out=None):
        model = bound_model(cfg, mesh, params)
        _serve_checks(rows, param_dtype, model, tokens)
        if enc_out is not None:
            caches = dict(caches, enc_out=enc_out)
        logits, caches = M.decode_step(cfg, model, caches, tokens, index,
                                       decode_mode=mode)
        caches.pop("enc_out", None)
        return logits, caches

    if cfg.encoder is not None:
        def fn(params, caches, tokens, index, enc_out):
            return run(params, caches, tokens, index, enc_out)
    else:
        def fn(params, caches, tokens, index):
            return run(params, caches, tokens, index)
    return DecodeBundle(fn=fn, rules=rules, seq=seq, decode_mode=mode)
