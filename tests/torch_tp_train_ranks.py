"""Rank function for ``tests/test_torch_tp_train.py``.

``launch.distributed.spawn_local`` pickles a rank function by name, and
each rank imports its module afresh, so it lives in a module of its own
that imports no JAX.  It returns numpy arrays, so the parent can hold
them against the reference.
"""
import torch

from repro_torch.compress import CompressionConfig
from repro_torch.configs import get_config
from repro_torch.convert import shard_for_rank
from repro_torch.dist.gossip import make_gossip_mixer
from repro_torch.dist.sharding import make_rules, param_partition_specs
from repro_torch.dist.steps import make_train_step
from repro_torch.launch.mesh import make_mesh
from repro_torch.sim.engine import node_stack
from repro_torch.topology import TopologySpec, build_schedule


def _numpy(tree):
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def _shards(cfg, full_np, rules, mesh):
    full = {k: torch.from_numpy(v) for k, v in full_np.items()}
    return node_stack(shard_for_rank(full, param_partition_specs(
        full, rules), mesh, mesh.coords), 1, "cpu")


def _node_batch(batches, step, node):
    """Node ``node``'s ``(1, b, ...)`` rows of step ``step``'s batch."""
    return {k: torch.from_numpy(v[node:node + 1])
            for k, v in batches[step].items()}


def _save_narrow(cfg, mesh, ckpt_dir):
    """"latest" of a (data 2, model 2) run restored onto (data 2, model
    1) by the model-coordinate-0 ranks and saved again there (under
    ``<ckpt_dir>/narrow``); returns the restored step (None on the other
    ranks)."""
    import os

    import torch.distributed as dist

    from repro_torch.checkpoint import AsyncCheckpointer, load_pytree
    from repro_torch.checkpoint.io import mesh_placement
    from repro_torch.launch.mesh import Mesh, rank_coords
    from repro_torch.models import model as M

    narrow = Mesh({"data": 2, "model": 1},
                  coords={"data": mesh.coords["data"], "model": 0})
    whole = M.param_specs(cfg, torch.float32)
    specs = param_partition_specs(whole, make_rules(
        narrow, arch_name=cfg.name, context="train"))
    firsts = [r for r in range(dist.get_world_size())
              if rank_coords(mesh, r)["model"] == 0]
    group = dist.new_group(firsts)      # every rank makes it
    if mesh.coords["model"]:
        return None
    row = {k: torch.zeros((1,) + tuple(v.shape)) for k, v in whole.items()}
    place = mesh_placement(specs, narrow, "data")
    tree = load_pytree({"params": row, "opt": {"u": dict(row)}, "step": 0},
                       ckpt_dir, "latest", placement=place)
    ckpt = AsyncCheckpointer(os.path.join(ckpt_dir, "narrow"), group=group,
                             placement=place)
    try:
        ckpt.save(tree, name="latest").result()
    finally:
        ckpt.close()
    return tree["step"]


def _train(bundle, params, batches, steps):
    opt = bundle.method.init(params)
    losses, shards = [], []
    for step in range(steps):
        params, opt, loss = bundle.step_fn(
            params, opt, _node_batch(batches, step, bundle.node), step)
        losses.append(float(loss))
        shards.append(_numpy({k: v[0] for k, v in params.items()}))
    return losses, shards


def train_cases(rank, device, cases):
    """Each case a dict with ``kind``, ``arch`` (reduced), ``mesh`` (a
    ``(shape, axis_names)`` pair, built by every rank in case order),
    ``params`` (the full flat dict, numpy f32) and ``batches`` (per
    step, numpy ``(nodes, b, ...)``):

    * ``"methods"``: for each of ``methods``, ``steps`` steps of the
      tensor-parallel step (``eta``), this rank's shards and its node's
      losses after each; with ``overlap`` the first method again with
      ``overlap=True``; and the one-model-rank distributed step over
      ``mesh.group("data")`` on the ranks of model coordinate 0 (the
      whole node's parameters after each step);
    * ``"grads"``: the step's ``grad_fn`` (``make_train_step`` given
      ``step_kw`` too) on step 0's batch (the node's loss, this rank's
      gradients) and one step after it;
    * ``"ckpt"``: the launcher's ``train_rank`` with ``opts`` (a mesh,
      checkpoints): this rank's final shards and its saves; then the
      ranks of model coordinate 0 restore "latest" onto (data 2, model
      1), each its node's whole row (``load_pytree(placement=)``), and
      save that under ``<ckpt_dir>/narrow`` as the ranks of that mesh;
    * ``"compress"``: one round of the compressed mixer over
      ``mesh.group("data")`` on this rank's shards of ``params`` (a
      node-stacked dict of the nodes' full trees) and of ``ef``, with
      ``compression`` at step counter ``t``.

    The gathers of each run are counted (``model.tp.stats`` and
    ``backward_stats``)."""
    torch.set_num_threads(1)
    out = []
    for case in cases:
        mesh = make_mesh(*case["mesh"])
        cfg = get_config(case["arch"]).reduced()
        res = {"coords": mesh.coords}
        if case["kind"] == "ckpt":
            from repro_torch.launch.train import train_rank
            got = train_rank(case["opts"], device)
            res.update(node=got.bundle.node, shards=_numpy(
                {k: v[0] for k, v in got.params.items()}),
                saves=[s["name"] for s in got.checkpoints])
            res["narrow_step"] = _save_narrow(cfg, mesh,
                                              case["opts"].ckpt_dir)
            out.append(res)
            continue
        if case["kind"] == "compress":
            rules = make_rules(mesh, arch_name=cfg.name, context="train")
            ccfg = CompressionConfig(**case["compression"])
            node = mesh.coords["data"]
            specs = param_partition_specs(
                {k: torch.from_numpy(v[0]) for k, v in
                 case["params"].items()}, rules)
            mine = {}
            for name in ("params", "ef"):
                tree = {k: torch.from_numpy(v[node]) for k, v in
                        case[name].items()}
                mine[name] = {k: v[None] for k, v in shard_for_rank(
                    tree, specs, mesh, mesh.coords).items()}
            n = mesh.shape["data"]
            plan = build_schedule(TopologySpec("base", n, 1)) \
                .as_ppermute_plan()
            mixer = make_gossip_mixer(mesh.group("data"), plan,
                                      compression=ccfg)
            mixed, ef = mixer(mine["params"], case["round"], mine["ef"],
                              case["t"])
            res.update(mixed=_numpy({k: v[0] for k, v in mixed.items()}),
                       ef=_numpy({k: v[0] for k, v in ef.items()}),
                       sent=dict(mixer.stats))
            out.append(res)
            continue
        kw = dict(topology="base", k=1, eta=case.get("eta", 0.05),
                  param_dtype=torch.float32, remat=case.get("remat", False))
        if case["kind"] == "grads":
            bundle = make_train_step(cfg, mesh=mesh, **kw,
                                     **case["step_kw"])
            params = _shards(cfg, case["params"], bundle.rules, mesh)
            loss, grads = bundle.grad_fn(
                params, _node_batch(case["batches"], 0, bundle.node))
            res.update(loss=float(loss),
                       grads=_numpy({k: v[0] for k, v in grads.items()}),
                       gathers=dict(bundle.model.tp.stats),
                       backward=dict(bundle.model.tp.backward_stats),
                       row_axes=bundle.model.tp.row_axes,
                       node=bundle.node, n_nodes=bundle.n_nodes)
            res["losses"], res["shards"] = _train(
                bundle, _shards(cfg, case["params"], bundle.rules, mesh),
                case["batches"], 1)
            out.append(res)
            continue
        runs = [(m, False) for m in case["methods"]]
        if case.get("overlap"):
            runs.append((case["methods"][0], True))
        for method, overlap in runs:
            bundle = make_train_step(cfg, mesh=mesh, method_name=method,
                                     overlap=overlap, **kw)
            params = _shards(cfg, case["params"], bundle.rules, mesh)
            res[(method, overlap)] = dict(zip(("losses", "shards"), _train(
                bundle, params, case["batches"], case["steps"])),
                sent=dict(bundle.mixer.stats),
                gathers=dict(bundle.model.tp.stats),
                backward=dict(bundle.model.tp.backward_stats))
            res["node"] = bundle.node
            if mesh.coords["model"]:
                continue
            # the one-model-rank step over this model coordinate's ranks
            one = make_train_step(cfg, mesh.group("data"),
                                  method_name=method, overlap=overlap, **kw)
            full = node_stack({k: torch.from_numpy(v) for k, v in
                               case["params"].items()}, 1, "cpu")
            res[(method, overlap, "one")] = dict(zip(
                ("losses", "params"),
                _train(one, full, case["batches"], case["steps"])),
                sent=dict(one.mixer.stats))
        out.append(res)
    return out
