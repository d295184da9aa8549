"""Tensor-parallel layers over a live mesh: a model bound to one rank's
shards, and the collectives its forward and backward run.

:func:`bind` builds a :class:`~repro_torch.models.model.Model` on the
meta device, puts this rank's shard of each tensor in its place (the
shapes :func:`~repro_torch.dist.sharding.param_partition_specs` gives)
and marks each module that holds a sharded tensor with a
:class:`Sharded`, which its forward calls.  ``bind(cfg, None, mesh)``
is the marked skeleton alone, for ``torch.func.functional_call`` with a
flat dict of shards (``models.model.loss_fn(..., model=)``, the
tensor-parallel train step).  A module with no sharded tensor, and every
module of a model that is not bound, runs as before: no collective, the
single-device path.

What each marked module computes, for ``w`` laid out by the rules:

* ``Dense`` (``w`` (d_in, d_out)): with d_out on an axis, the rank's
  column block of ``x @ w``, all-gathered over that axis; with d_in on
  an axis too (the 2-D rule), the product of the rank's slice of ``x``
  with its block, in f32, the partial sums added over that axis, then
  rounded once and gathered.  The (replicated) bias is added once, after
  the gather.
* ``Embed`` (the table (V, D)): the D slice of each token's row, gathered
  over D's axis; with V on an axis too, the rank looks up the tokens in
  its rows (zeros elsewhere) and the rows are added over V's axis, where
  exactly one term is not zero.
* The tied head ``h @ table.T`` contracts over the sharded D: each rank
  multiplies its slice of ``h`` in f32, and the partial logits are added
  over D's axis in rank order, then rounded once (kept in f32 for the
  training loss, :meth:`Sharded.head_f32`).  Every rank of the group adds
  the same terms in the same order, so all hold the same logits bit for
  bit and pick the same token.
* The MoE's ``router`` / ``w_gate`` / ``w_up`` / ``w_down`` and a Mamba
  layer's ``conv_w``: gathered whole where they are used and dropped
  after (:meth:`Sharded.whole`).

**Rows.**  In training the batch rows may be split over axes of their
own (the train rules' ``dp``: "data" under the 2-D rule, "pod" for the
small archs of a multi-pod mesh); the step names them in
``Collectives.row_axes`` (empty in serving, whose rows never meet a
weight axis).  A rank then holds other rows than its peers on those
axes, so a weight dim laid out on one of them is gathered whole over it
at its use (:meth:`Sharded.param`, as FSDP does: the embedding table's
vocabulary rows, a matrix's contraction dim) before the product.  An MoE
layer routes the node's whole batch: its rows are gathered over the row
axes before the router and its routed output split back
(``models.moe``), so the capacity and the aux loss are the reference's.

**The backward** (each collective is a ``torch.autograd.Function``).
The loss and every replicated activation are one value, held
identically by each rank of a group: the gradient of a replicated
tensor is complete, and bit-identical, on each rank; the gradient of a
shard is the gradient of that slice of the whole tensor.  A parameter
used on the rank's rows only gets the share of its gradient those rows
give: a weight gathered over a row axis adds its shares over the row
axes in its gather's backward, before it takes its slice
(:class:`_GatherRows`), and the step adds the others' shares over the
row axes in rank order (:func:`rows_share_keys`), except for the MoE's
routed tensors, which see the whole batch.  The contract of each
collective is in its class's docstring.

Everything after a gather runs replicated within the group: attention
(the flash kernel on the card), norms, rope, routing, the SSD scan.  So a
rank's caches are the one-rank caches of its batch rows.

Every collective is an all-gather (a sum over an axis is a gather and an
ordered sum, never a reduction whose order the backend picks): over
nccl on card tensors; over gloo a card tensor goes through pinned host
memory (``dist.gossip.HostStaging``) and back.  ``Collectives.stats``
counts the gathers and the bytes this rank received, and
``Collectives.backward_stats`` the share of them a backward pass made
(a checkpointed block's recomputed forward counts as forward).

On a dry mesh (``launch.mesh.dry_mesh``: a rank's coordinates, stand-ins
for its groups) :func:`bind` uses :class:`DryCollectives`, which give
each gather's pieces as empty tensors of its shape and count the gathers
and bytes as the live class does, and send nothing: with the shards on
the meta device, a step's collectives are counted without a card or a
group (``launch.dryrun``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.models import model as M
from repro_torch.models.layers import Dense, Embed
from repro_torch.models.mamba2 import Mamba
from repro_torch.models.moe import MoE

from .gossip import HostStaging
from .sharding import local_shape, make_rules, param_partition_specs


class Collectives:
    """All-gathers over the axes of a live mesh, in coordinate order, and
    their differentiable forms (:meth:`cat`, :meth:`sum`,
    :meth:`replicate`, :meth:`split`).  ``row_axes``: the axes the batch
    rows of the current step are split over (set by the train step)."""

    def __init__(self, mesh):
        if not mesh.live:
            raise ValueError("tensor-parallel layers need a live mesh "
                             "(launch.mesh.make_mesh / make_host_mesh)")
        self.mesh = mesh
        self.stats = {"collectives": 0, "bytes": 0}
        self.backward_stats = {"collectives": 0, "bytes": 0}
        self.row_axes: tuple = ()
        self._staging = HostStaging()
        self._in_backward = False

    def _count(self, n: int, nbytes: int) -> None:
        """One gather over ``n`` ranks of ``nbytes`` a rank."""
        for stats in (self.stats, self.backward_stats) \
                if self._in_backward else (self.stats,):
            stats["collectives"] += 1
            stats["bytes"] += (n - 1) * nbytes

    def gather(self, t: torch.Tensor, axis: str) -> list:
        """Every rank's ``t`` along ``axis``, in coordinate order (this
        rank's own is ``t`` itself)."""
        n = self.mesh.shape[axis]
        if n == 1:
            return [t]
        group = self.mesh.group(axis)
        t = t.contiguous()
        flat = t.reshape(-1).view(torch.uint8)
        me = self.mesh.coords[axis]
        if t.is_cuda and dist.get_backend(group) == "gloo":
            host, done = self._staging.out(flat)
            done.synchronize()
            outs = [torch.empty(host.shape, dtype=torch.uint8,
                                pin_memory=True) for _ in range(n)]
            dist.all_gather(outs, host, group=group)
            outs = [o if i == me else o.to(t.device, non_blocking=True)
                    for i, o in enumerate(outs)]
        else:
            outs = [torch.empty_like(flat) for _ in range(n)]
            dist.all_gather(outs, flat, group=group)
        self._count(n, flat.numel())
        return [t if i == me else o.view(t.dtype).reshape(t.shape)
                for i, o in enumerate(outs)]

    def ordered_sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``t`` over ``axis``, added in coordinate order (not
        differentiated)."""
        pieces = self.gather(t, axis)
        acc = pieces[0]
        for p in pieces[1:]:
            acc = acc + p
        return acc

    def cat(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The pieces of ``t`` along ``axis`` joined on ``dim``
        (:class:`_Cat`)."""
        if self.mesh.shape[axis] == 1:
            return t
        return _Cat.apply(t, self, axis, dim)

    def sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``t`` over ``axis``, added in coordinate order
        (:class:`_Sum`)."""
        if self.mesh.shape[axis] == 1:
            return t
        if not t.is_floating_point():
            return self.ordered_sum(t, axis)
        return _Sum.apply(t, self, axis)

    def replicate(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``t``, a tensor replicated over ``axis`` that feeds a product
        whose output is sharded over it (:class:`_Replicate`)."""
        if self.mesh.shape[axis] == 1:
            return t
        return _Replicate.apply(t, self, axis)

    def split(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """This rank's part along ``dim`` of ``t``, a tensor replicated
        over ``axis`` (:class:`_Split`)."""
        if self.mesh.shape[axis] == 1:
            return t
        return _Split.apply(t, self, axis, dim)

    def cat_rows(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The node's whole batch from this rank's rows (``dim``), joined
        over :attr:`row_axes` in the order :func:`dist.steps.local_rows`
        cuts them (the first axis major)."""
        for axis in reversed(self.row_axes):
            t = self.cat(t, axis, dim)
        return t

    def split_rows(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's rows (``dim``) of a whole-batch tensor: the inverse
        of :meth:`cat_rows`."""
        for axis in self.row_axes:
            t = self.split(t, axis, dim)
        return t

    def sum_rows(self, t: torch.Tensor, *, grad: bool = True):
        """``t`` added over :attr:`row_axes` in rank order
        (:meth:`sum`, or :meth:`ordered_sum` with ``grad=False``)."""
        for axis in self.row_axes:
            t = self.sum(t, axis) if grad else self.ordered_sum(t, axis)
        return t


class DryCollectives(Collectives):
    """:class:`Collectives` on a dry mesh: a gather of a meta tensor
    returns this rank's ``t`` and an empty tensor of its shape for each
    other rank, counted in ``stats`` and ``backward_stats`` as the live
    gather counts; nothing is sent.  A tensor with storage raises: its
    gather would be uninitialised memory."""

    def gather(self, t: torch.Tensor, axis: str) -> list:
        if t.device.type != "meta":
            raise ValueError(f"a dry mesh gathers meta tensors only, got "
                             f"one on {t.device}")
        n = self.mesh.shape[axis]
        if n == 1:
            return [t]
        self._count(n, t.numel() * t.element_size())
        me = self.mesh.coords[axis]
        return [t if i == me else torch.empty_like(t) for i in range(n)]


class _Backward:
    """Counts the gathers of a backward in ``backward_stats`` too."""

    def __init__(self, comm):
        self.comm = comm

    def __enter__(self):
        self.comm._in_backward = True

    def __exit__(self, *exc):
        self.comm._in_backward = False


def _own(comm, axis, dim, width, t):
    """This rank's ``width`` slice of ``t`` along ``dim`` on ``axis``."""
    return t.narrow(dim, comm.mesh.coords[axis] * width, width)


class _Cat(torch.autograd.Function):
    """Gather-and-join: forward, every rank's ``t`` along ``axis`` joined
    on ``dim`` in coordinate order.  Backward: the rank's own slice of
    the incoming gradient (the output is replicated over ``axis``, so its
    gradient is the same complete tensor on every rank)."""

    @staticmethod
    def forward(ctx, t, comm, axis, dim):
        ctx.comm, ctx.axis, ctx.dim = comm, axis, dim
        ctx.width = t.shape[dim]
        return torch.cat(comm.gather(t, axis), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (_own(ctx.comm, ctx.axis, ctx.dim, ctx.width, g), None, None,
                None)


class _Sum(torch.autograd.Function):
    """Ordered sum of partial products: forward, ``t`` added over
    ``axis`` in coordinate order.  Backward: the gradient passes through
    unchanged (each rank's term enters the replicated sum once)."""

    @staticmethod
    def forward(ctx, t, comm, axis):
        return comm.ordered_sum(t, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Replicate(torch.autograd.Function):
    """A replicated input that feeds a rank-local product (``x`` into a
    column-sharded ``Dense``): identity forward.  Backward: each rank's
    gradient holds only its product's share, so the shares are added
    over ``axis`` in coordinate order (the forward sum's order), and
    every rank gets the same bits whatever order the backend would
    reduce in."""

    @staticmethod
    def forward(ctx, t, comm, axis):
        ctx.comm, ctx.axis = comm, axis
        return t

    @staticmethod
    def backward(ctx, g):
        with _Backward(ctx.comm):
            return ctx.comm.ordered_sum(g, ctx.axis), None, None


class _Split(torch.autograd.Function):
    """This rank's slice along ``dim`` of a tensor replicated over
    ``axis`` (the contraction slice of ``x``, a rank's rows of a
    whole-batch output): forward, the slice.  Backward: every rank's
    gradient slice gathered and joined in coordinate order, the complete
    gradient of the replicated input."""

    @staticmethod
    def forward(ctx, t, comm, axis, dim):
        n = comm.mesh.shape[axis]
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"over the {n} ranks of {axis!r}")
        ctx.comm, ctx.axis, ctx.dim = comm, axis, dim
        return _own(comm, axis, dim, t.shape[dim] // n, t)

    @staticmethod
    def backward(ctx, g):
        with _Backward(ctx.comm):
            return (torch.cat(ctx.comm.gather(g, ctx.axis), dim=ctx.dim),
                    None, None, None)


class _GatherRows(_Cat):
    """A weight gathered whole over ``axis``, one of the axes that split
    the batch rows, for a product with this rank's rows (FSDP's gather):
    forward, as :class:`_Cat`.  Backward: the whole tensor's gradient
    holds the share of this rank's rows, so it is added over every row
    axis in coordinate order first, then the rank's slice is taken (its
    rows' peers hold other slices, so the slices cannot be added
    after)."""

    @staticmethod
    def backward(ctx, g):
        with _Backward(ctx.comm):
            g = ctx.comm.sum_rows(g, grad=False)
        return (_own(ctx.comm, ctx.axis, ctx.dim, ctx.width, g), None, None,
                None)


class Sharded:
    """The layout of one module's tensors (``specs``: leaf name -> spec)
    and the collectives its forward runs over ``comm``."""

    def __init__(self, comm: Collectives, specs: dict):
        self.comm, self.specs = comm, specs
        # the embedding's lookup on the table gathered whole first (the
        # train step's ``embed_lookup_replicated``)
        self.lookup_whole = False

    def param(self, t: torch.Tensor, name: str):
        """``t`` (the module's tensor ``name``) with the dim laid out on a
        row axis gathered whole over it (:class:`_GatherRows`), and the
        spec of what is left sharded."""
        spec = list(self.specs[name])
        for dim, axis in enumerate(spec):
            if axis is not None and axis in self.comm.row_axes:
                t = _GatherRows.apply(t, self.comm, axis, dim)
                spec[dim] = None
        return t, spec

    def _product(self, x, w, ax_in, ax_out, f32=False):
        """``x @ w`` for ``w`` laid out ``(ax_in, ax_out)``: f32 partial
        products added over ``ax_in`` in rank order, then (unless
        ``f32``) rounded once to ``x``'s dtype; the columns gathered over
        ``ax_out``.  With ``f32`` the product is in f32 throughout, as
        ``layers.chunked_ce_loss`` takes its logits."""
        if ax_out is not None:
            x = self.comm.replicate(x, ax_out)
        if ax_in is None:
            y = x.float() @ w.float() if f32 else x @ w
        else:
            y = self.comm.sum(self.comm.split(x, ax_in, -1).float()
                              @ w.float(), ax_in)
            if not f32:
                y = y.to(x.dtype)
        if ax_out is not None:
            y = self.comm.cat(y, ax_out, -1)
        return y

    def dense(self, mod: Dense, x):
        w, (ax_in, ax_out) = self.param(mod.w, "w")
        y = self._product(x, w, ax_in, ax_out)
        if mod.b is not None:
            y = y + mod.b
        return y

    def dense_f32(self, w: torch.Tensor):
        """``hc -> hc @ w`` in f32 for ``w`` the module's ``w`` (the untied
        head in the training loss), ``w`` gathered and cast once."""
        w, (ax_in, ax_out) = self.param(w, "w")
        w = w.float()
        return lambda hc: self._product(hc, w, ax_in, ax_out, f32=True)

    def embed(self, mod: Embed, tokens):
        if self.lookup_whole:
            return self.whole(mod, "table")[tokens]
        table, (ax_v, ax_d) = self.param(mod.table, "table")
        if ax_v is None:
            x = table[tokens]
        else:
            v = table.shape[0]
            lo = self.comm.mesh.coords[ax_v] * v
            mine = (tokens >= lo) & (tokens < lo + v)
            x = table[torch.where(mine, tokens - lo, 0)]
            x = self.comm.sum(torch.where(mine[..., None], x, 0), ax_v)
        if ax_d is not None:
            x = self.comm.cat(x, ax_d, -1)
        return x

    def head(self, table, h):
        """``h @ table.T`` for the tied head; the caller applies the
        softcap."""
        table, (ax_v, ax_d) = self.param(table, "table")
        return self._product(h, table.T, ax_d, ax_v)

    def head_f32(self, table: torch.Tensor):
        """``hc -> hc @ table.T`` in f32 (the tied head in the training
        loss), the table gathered and cast once for every chunk."""
        table, (ax_v, ax_d) = self.param(table, "table")
        w = table.float().T
        return lambda hc: self._product(hc, w, ax_d, ax_v, f32=True)

    def whole(self, mod: nn.Module, name: str, *,
              whole_batch: bool = False):
        """The whole tensor ``mod.<name>``, gathered along each sharded
        dim (the rank's own shard when nothing is sharded).  Backward:
        the rank's slice of the whole tensor's gradient.  With
        ``whole_batch`` (an MoE's routed tensors, whose consumer takes the
        node's whole batch) that gradient is complete (:class:`_Cat`).
        Otherwise (a Mamba layer's ``conv_w``) it holds the share of the
        rank's rows: a dim on a row axis is gathered by
        :class:`_GatherRows`, whose backward adds the shares over the
        row axes before it slices, and the step adds a tensor's shares
        that no row axis slices after the backward."""
        t, spec = (getattr(mod, name), self.specs[name]) if whole_batch \
            else self.param(getattr(mod, name), name)
        for dim, axis in enumerate(spec):
            if axis is not None:
                t = self.comm.cat(t, axis, dim)
        return t


#: the modules whose forward knows :class:`Sharded`
_SHARDABLE = (Dense, Embed, MoE, Mamba)

#: an MoE's tensors that see the node's whole batch (the routed experts)
_WHOLE_BATCH = ("router", "w_gate", "w_up", "w_down")


def bind(cfg, shards: dict | None, mesh, *, context: str = "serve"
         ) -> M.Model:
    """A :class:`~repro_torch.models.model.Model` of ``cfg`` holding this
    rank's ``shards`` (a flat dict keyed as the model's ``state_dict``,
    each tensor this rank's slice under ``context``'s rules on ``mesh``),
    its sharded modules marked.  The tensors are used as they are, not
    copied.  ``model.tp`` is the :class:`Collectives` every marked module
    shares.

    ``context="serve"``: frozen parameters, ``eval()``.
    ``context="train"``: the shards are trainable (``requires_grad``),
    the model in training mode.  ``shards=None``: the marked skeleton
    on the meta device, for ``functional_call`` with a dict of shards
    (``models.model.loss_fn(..., model=)``)."""
    rules = make_rules(mesh, arch_name=cfg.name, context=context)
    model = M.Model(cfg, device="meta")
    full = model.state_dict()
    specs = param_partition_specs(full, rules)
    if shards is not None:
        if set(shards) != set(full):
            raise ValueError(
                f"{cfg.name}: the shards' keys differ from the model's: "
                f"missing {sorted(set(full) - set(shards))}, unknown "
                f"{sorted(set(shards) - set(full))}")
        for key, t in shards.items():
            want = local_shape(full[key].shape, specs[key], mesh)
            if tuple(t.shape) != want:
                raise ValueError(f"{key}: a shard of {tuple(full[key].shape)}"
                                 f" under {specs[key]} is {want}, got "
                                 f"{tuple(t.shape)}")
            owner, _, leaf = key.rpartition(".")
            setattr(model.get_submodule(owner), leaf,
                    nn.Parameter(t, requires_grad=context == "train"))
    comm = (DryCollectives if mesh.dry else Collectives)(mesh)
    for name, mod in model.named_modules():
        local = {leaf: specs[f"{name}.{leaf}" if name else leaf]
                 for leaf, _ in mod.named_parameters(recurse=False)}
        if not any(a is not None for s in local.values() for a in s):
            continue
        if not isinstance(mod, _SHARDABLE):
            raise NotImplementedError(
                f"{name}: a {type(mod).__name__} has sharded tensors "
                f"({local}) and no tensor-parallel forward")
        mod.tp = Sharded(comm, local)
    model.tp = comm
    return model.train(context == "train")


def rows_share_keys(model: M.Model) -> list:
    """With the batch rows split (``model.tp.row_axes``), the keys of the
    tensors whose gradient after the backward is the share of this
    rank's rows, on a slice its row peers share: every tensor but an
    MoE's routed ones (:data:`_WHOLE_BATCH`: they see the node's whole
    batch, their gradients complete) and those with a dim on a row axis
    (:class:`_GatherRows` added their shares in the backward).  The step
    adds these over the row axes."""
    rows = model.tp.row_axes
    keys = []
    for name, mod in model.named_modules():
        tp = getattr(mod, "tp", None)
        for leaf, _ in mod.named_parameters(recurse=False):
            if isinstance(mod, MoE) and leaf in _WHOLE_BATCH:
                continue
            spec = tp.specs[leaf] if isinstance(tp, Sharded) else ()
            if not any(a in rows for a in spec if a is not None):
                keys.append(f"{name}.{leaf}" if name else leaf)
    return keys


def shard_bytes(cfg, dtype, mesh) -> int:
    """The bytes of one rank's shards of ``cfg``'s parameters in
    ``dtype`` under the serve rules on ``mesh``: what a bound model
    holds."""
    rules = make_rules(mesh, arch_name=cfg.name, context="serve")
    full = M.param_specs(cfg, dtype)
    specs = param_partition_specs(full, rules)
    size = torch.empty((), dtype=dtype).element_size()
    return sum(size * torch.Size(local_shape(t.shape, specs[k], mesh))
               .numel() for k, t in full.items())
