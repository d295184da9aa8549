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

Not ported yet (they raise ``NotImplementedError``): tensor-parallel
meshes (``dist/sharding.py``: one rank is one whole node here), the
gossip/backward ``overlap`` and the serving steps ``make_prefill`` /
``make_decode_step``.  The reference's ``embed_lookup_replicated`` and
``batch_shapes`` lay its embedding table and batch out over the mesh's
weight axes; a rank that holds one whole node has nothing to lay out.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch import trace
from repro_torch.compress import CompressionConfig
from repro_torch.compress import resolve as resolve_compression
from repro_torch.core.ppermute_plan import SchedulePlan
from repro_torch.models import model as M
from repro_torch.optim.decentralized import Method, make_method
from repro_torch.sim.engine import _map, node_grads
from repro_torch.topology import (Schedule, TopologySpec, as_schedule,
                                  spec_from_cli)

from .gossip import make_gossip_mixer


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


def make_train_step(cfg, group=None, *,
                    topology: str | TopologySpec | Schedule = "base",
                    k: int = 1, method_name: str = "dsgdm",
                    eta: float = 0.01, param_dtype=torch.bfloat16,
                    remat: bool = True, momentum: float = 0.9,
                    flatten_gossip: bool = False, compression=None,
                    overlap: bool = False) -> TrainStepBundle:
    """One DSGD-family step of this rank's node: its gradients -> the
    method update -> gossip round ``step % n_rounds`` over ``group``
    (None: the default group; its size is the node count).

    ``topology`` is a registered name (with ``k``), an inline JSON spec
    string, a ``TopologySpec`` (its ``n`` must match the group's size) or
    a prebuilt ``Schedule``.  ``compression`` (a ``CompressionConfig``,
    a CLI string such as ``"int8"``, or None) turns the gossip into
    quantized, error-feedback payload exchange; the EF residuals and the
    step counter ride in the method's state.  ``remat`` checkpoints each
    pattern block of the forward (``models.model.loss_fn``).

    ``bundle.step_fn(params_1, opt, batch_1, step)`` takes this node's
    flat dict of ``param_dtype`` float tensors (node axis of size 1),
    the method state, this node's batch (``{"tokens", "labels"}``,
    leading axis of size 1) and the step index, and returns the new
    parameters, the new state and this node's loss (a 0-d tensor)."""
    if overlap:
        raise NotImplementedError(
            "gossip/backward overlap is not ported to repro_torch yet; see "
            "ROADMAP.md")
    ccfg = resolve_compression(compression)
    n = dist.get_world_size(group)
    if isinstance(topology, Schedule):
        if topology.n != n:
            raise ValueError(f"schedule built for n={topology.n} but the "
                             f"group has {n} ranks")
        sched = topology
    else:
        sched = as_schedule(spec_from_cli(topology, n=n, k=k))
    plan = sched.as_ppermute_plan()
    method = make_method(method_name, momentum, compression=ccfg)
    mixer = make_gossip_mixer(group, plan, flatten=flatten_gossip,
                              compression=ccfg)

    def loss_one(p, b):
        return M.loss_fn(cfg, p, b, remat=remat)[0]

    def step_fn(params_1, opt, batch, step):
        bad = {k: x.dtype for k, x in params_1.items()
               if x.is_floating_point() and x.dtype != param_dtype}
        if bad:
            raise TypeError(f"the step takes {param_dtype} parameters, got "
                            f"{bad}")
        dev = next(iter(params_1.values())).device
        batch = _map(lambda a: torch.as_tensor(a).to(dev), batch)
        trace.mark("step")
        losses, grads = node_grads(loss_one, params_1, batch)
        trace.mark("update")
        with torch.no_grad():
            if ccfg is not None:
                params_1, opt = method.step(
                    params_1, grads, opt,
                    lambda tr, e, c: mixer(tr, step, e, c), eta)
            else:
                params_1, opt = method.step(
                    params_1, grads, opt, lambda t: mixer(t, step), eta)
        trace.mark("end")
        return params_1, opt, losses[0]

    return TrainStepBundle(
        step_fn=step_fn, n_rounds=len(sched), plan=plan, spec=sched.spec,
        compression=ccfg, method=method, mixer=mixer)


def make_prefill(*args, **kwargs):
    raise NotImplementedError(
        "distributed serving (make_prefill) is not ported to repro_torch "
        "yet; see ROADMAP.md")


def make_decode_step(*args, **kwargs):
    raise NotImplementedError(
        "distributed serving (make_decode_step) is not ported to "
        "repro_torch yet; see ROADMAP.md")
