"""Tensor-parallel layers over a live mesh: a model bound to one rank's
shards, and the collectives its forward runs.

:func:`bind` builds a :class:`~repro_torch.models.model.Model` on the
meta device, puts this rank's shard of each tensor in its place (the
shapes :func:`~repro_torch.dist.sharding.param_partition_specs` gives on
the serve rules) and marks each module that holds a sharded tensor with
a :class:`Sharded`, which its forward calls.  A module with no sharded
tensor, and every module of a model that is not bound, runs as before:
no collective, the single-device path.

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
  over D's axis in rank order, then rounded once.  Every rank of the
  group adds the same terms in the same order, so all hold the same
  logits bit for bit and pick the same token.
* The MoE's ``router`` / ``w_gate`` / ``w_up`` / ``w_down`` and a Mamba
  layer's ``conv_w``: gathered whole where they are used and dropped
  after (:meth:`Sharded.whole`).

Everything after a gather runs replicated within the group: attention
(the flash kernel on the card), norms, rope, routing, the SSD scan.  So a
rank's caches are the one-rank caches of its batch rows.

Every collective is an all-gather (a sum over an axis is a gather and an
ordered sum): over nccl on card tensors; over gloo a card tensor goes
through pinned host memory (``dist.gossip.HostStaging``) and back.
``Collectives.stats`` counts the gathers and the bytes this rank
received.
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
    """All-gathers over the axes of a live mesh, in coordinate order."""

    def __init__(self, mesh):
        if not mesh.live:
            raise ValueError("tensor-parallel layers need a live mesh "
                             "(launch.mesh.make_mesh / make_host_mesh)")
        self.mesh = mesh
        self.stats = {"collectives": 0, "bytes": 0}
        self._staging = HostStaging()

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
        self.stats["collectives"] += 1
        self.stats["bytes"] += (n - 1) * flat.numel()
        return [t if i == me else o.view(t.dtype).reshape(t.shape)
                for i, o in enumerate(outs)]

    def cat(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The pieces of ``t`` along ``axis`` joined on ``dim``."""
        return torch.cat(self.gather(t, axis), dim=dim)

    def sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``t`` over ``axis``, added in coordinate order."""
        pieces = self.gather(t, axis)
        acc = pieces[0]
        for p in pieces[1:]:
            acc = acc + p
        return acc


class Sharded:
    """The layout of one module's tensors (``specs``: leaf name -> spec)
    and the collectives its forward runs over ``comm``."""

    def __init__(self, comm: Collectives, specs: dict):
        self.comm, self.specs = comm, specs

    def _slice(self, x, axis, width):
        """This rank's ``width`` columns of ``x``'s last dim along
        ``axis``."""
        c = self.comm.mesh.coords[axis]
        return x[..., c * width:(c + 1) * width]

    def _contract(self, x, w, axis):
        """``x @ w`` with the contraction dim of ``w`` sharded over
        ``axis``: f32 partial products added in rank order."""
        part = self._slice(x, axis, w.shape[0]).float() @ w.float()
        return self.comm.sum(part, axis)

    def dense(self, mod: Dense, x):
        ax_in, ax_out = self.specs["w"]
        if ax_in is None:
            y = x @ mod.w
        else:
            y = self._contract(x, mod.w, ax_in).to(x.dtype)
        if ax_out is not None:
            y = self.comm.cat(y, ax_out, -1)
        if mod.b is not None:
            y = y + mod.b
        return y

    def embed(self, mod: Embed, tokens):
        ax_v, ax_d = self.specs["table"]
        table = mod.table
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
        ax_v, ax_d = self.specs["table"]
        if ax_d is None:
            y = h @ table.T
        else:
            y = self._contract(h, table.T, ax_d).to(h.dtype)
        if ax_v is not None:
            y = self.comm.cat(y, ax_v, -1)
        return y

    def whole(self, mod: nn.Module, name: str):
        """The whole tensor ``mod.<name>``, gathered along each sharded
        dim (the rank's own shard when nothing is sharded)."""
        t = getattr(mod, name)
        for dim, axis in enumerate(self.specs[name]):
            if axis is not None:
                t = self.comm.cat(t, axis, dim)
        return t


#: the modules whose forward knows :class:`Sharded`
_SHARDABLE = (Dense, Embed, MoE, Mamba)


def bind(cfg, shards: dict, mesh) -> M.Model:
    """A :class:`~repro_torch.models.model.Model` of ``cfg`` holding this
    rank's ``shards`` (a flat dict keyed as the model's ``state_dict``,
    each tensor this rank's slice under the serve rules on ``mesh``), its
    sharded modules marked.  The tensors are used as they are, not
    copied.  ``model.tp`` is the :class:`Collectives` every marked module
    shares."""
    rules = make_rules(mesh, arch_name=cfg.name, context="serve")
    model = M.Model(cfg, device="meta")
    full = model.state_dict()
    specs = param_partition_specs(full, rules)
    if set(shards) != set(full):
        raise ValueError(f"{cfg.name}: the shards' keys differ from the "
                         f"model's: missing {sorted(set(full) - set(shards))}"
                         f", unknown {sorted(set(shards) - set(full))}")
    for key, t in shards.items():
        want = local_shape(full[key].shape, specs[key], mesh)
        if tuple(t.shape) != want:
            raise ValueError(f"{key}: a shard of {tuple(full[key].shape)} "
                             f"under {specs[key]} is {want}, got "
                             f"{tuple(t.shape)}")
        owner, _, leaf = key.rpartition(".")
        setattr(model.get_submodule(owner), leaf,
                nn.Parameter(t, requires_grad=False))
    comm = Collectives(mesh)
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
    return model.eval()


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
