"""Rank function for ``tests/test_torch_tp_serve.py``.

``launch.distributed.spawn_local`` pickles a rank function by name, and
each rank imports its module afresh, so it lives in a module of its own
that imports no JAX.  It returns numpy arrays, so the parent can hold
them against the reference.
"""
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.convert import shard_for_rank
from repro_torch.dist.sharding import (batch_partition_specs, make_rules,
                                       param_partition_specs)
from repro_torch.dist.steps import (local_rows, make_decode_step,
                                    make_prefill)
from repro_torch.dist.tp import bind
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve import make_engine


def serve_cases(rank, device, cases, model_axis):
    """Each case ``(arch, params, batch, forced, new, speculate_k,
    draft)`` on a
    ``(world // model_axis, model_axis)`` mesh: ``params`` the full flat
    dict (numpy, f32) of the reduced arch, ``batch`` the whole serve batch
    (numpy), ``forced`` (B, steps) tokens the decode steps take one at a
    time after the prompt.  Returns, per case, this rank's rows, its
    shards, the prefill and decode logits of its rows, the gathers of
    one decode step, and the greedy tokens of ``make_engine(mesh=)``
    (plain, and with ``speculate_k`` self-speculative when it is set;
    with ``draft``, the full flat dict of a 1-block draft model of the
    arch, also through that draft model, keyed ``"draft"``, beside its
    ``SpecStats``)."""
    torch.set_num_threads(1)
    mesh = make_host_mesh(model=model_axis)
    out = []
    for arch, params, batch, forced, new, spec_k, draft in cases:
        cfg = get_config(arch).reduced()
        rules = make_rules(mesh, arch_name=arch, context="serve")
        full = {k: torch.from_numpy(v) for k, v in params.items()}
        shards = shard_for_rank(full, param_partition_specs(full, rules),
                                mesh, mesh.coords)
        whole = {k: torch.from_numpy(v) for k, v in batch.items()}
        mine = shard_for_rank(dict(whole), batch_partition_specs(
            whole, rules, node_stacked=False), mesh, mesh.coords)
        B, P = whole["tokens"].shape
        row0, rows = local_rows(rules, B)
        npfx = mine["prefix_embeds"].shape[1] \
            if "prefix_embeds" in mine else 0
        seq = npfx + P + forced.shape[1] + 1
        kw = dict(batch=B, seq=seq, param_dtype=torch.float32)
        pre = make_prefill(cfg, mesh, cache_dtype=torch.float32, **kw)
        dec = make_decode_step(cfg, mesh, **kw)
        model = bind(cfg, shards, mesh)
        with torch.inference_mode():
            logits, caches, enc = pre.fn(shards, mine)
            steps = []
            for i in range(forced.shape[1]):
                tok = torch.from_numpy(forced[row0:row0 + rows, i:i + 1])
                before = dict(model.tp.stats)
                lg, caches = dec.fn(model, caches, tok, npfx + P + i,
                                    *(() if enc is None else (enc,)))
                gathers = {k: model.tp.stats[k] - before[k] for k in before}
                steps.append(lg.numpy())
        engines = {}
        for k in (0, spec_k) if spec_k else (0,):
            eng = make_engine(cfg, batch=B, prompt_len=P, max_new=new,
                              prefix_len=npfx, param_dtype=torch.float32,
                              cache_dtype=torch.float32, speculate_k=k,
                              device="cpu", mesh=mesh)
            engines[k] = eng.generate_with_state(model, mine).tokens.numpy()
        stats = None
        if draft is not None:
            dcfg = dataclasses.replace(cfg, num_blocks=1)
            dfull = {k: torch.from_numpy(v) for k, v in draft.items()}
            dshards = shard_for_rank(dfull, param_partition_specs(
                dfull, make_rules(mesh, arch_name=dcfg.name,
                                  context="serve")), mesh, mesh.coords)
            eng = make_engine(cfg, batch=B, prompt_len=P, max_new=new,
                              param_dtype=torch.float32,
                              cache_dtype=torch.float32, speculate_k=spec_k,
                              draft_cfg=dcfg, device="cpu", mesh=mesh)
            res = eng.generate_with_state(model, mine, draft_params=dshards)
            engines["draft"] = res.tokens.numpy()
            stats = [t.numpy() for t in res.spec]
        out.append({
            "coords": mesh.coords, "row0": row0, "rows": rows,
            "dp": rules.dp, "decode_mode": dec.decode_mode,
            "shards": {k: v.numpy() for k, v in shards.items()},
            "prefill": logits.numpy(),
            "enc": None if enc is None else enc.numpy(),
            "decode": steps, "gathers": gathers, "tokens": engines,
            "draft_stats": stats})
    return out
