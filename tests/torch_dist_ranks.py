"""Rank functions for ``tests/test_torch_dist.py``.

``launch.distributed.spawn_local`` pickles a rank function by name, and
each rank imports its module afresh, so these live in a module of their
own that imports no JAX: a rank loads only torch and the port.  Each
returns numpy arrays, so the parent can hold them against the reference.
"""
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data.synthetic import token_batches
from repro_torch.dist import gossip
from repro_torch.dist.gossip import make_gossip_mixer
from repro_torch.dist.steps import make_train_step
from repro_torch.kernels import ops
from repro_torch.sim.engine import node_stack
from repro_torch.topology import TopologySpec, build_schedule


def _numpy(tree):
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def _mixer_with_cap(cap, group, plan, flatten, compression=None):
    """The mixer built while ``gossip.BUCKET_BYTES`` is ``cap``."""
    kept = gossip.BUCKET_BYTES
    gossip.BUCKET_BYTES = cap
    try:
        return make_gossip_mixer(group, plan, flatten=flatten,
                                 compression=compression)
    finally:
        gossip.BUCKET_BYTES = kept


def _counting(names, calls):
    """Wrap ``ops.<name>`` for each name so that each call appends its
    name to ``calls``; returns the functions to restore."""
    real = {name: getattr(ops, name) for name in names}

    def wrap(name):
        def counting(*args, **kw):
            calls.append(name)
            return real[name](*args, **kw)
        return counting

    for name in names:
        setattr(ops, name, wrap(name))
    return real


def mixer_rounds(rank, device, tree_np, cases):
    """For each ``(name, n, k, flatten)`` case, this rank's mixed slice
    after each round, every round applied to the same inputs, with the
    mixer's bucket cap and with one bucket per tensor (a cap of 0), and
    the grouped combines (``ops.gossip_mix_many`` calls) each made per
    round.  A case of n < world size runs in the subgroup of ranks
    0..n-1; every rank builds the subgroups, as ``new_group`` asks."""
    torch.set_num_threads(1)
    world = dist.get_world_size()
    groups = {n: dist.new_group(list(range(n)))
              for n in sorted({c[1] for c in cases}) if n < world}
    calls = []
    real = ops.gossip_mix_many

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    ops.gossip_mix_many = counting
    out = {}
    try:
        for name, n, k, flatten in cases:
            if rank >= n:
                continue
            group = groups.get(n)
            plan = build_schedule(TopologySpec(name=name, n=n,
                                               k=k)).as_ppermute_plan()
            mine = {key: torch.from_numpy(v[:n][rank:rank + 1]).to(device)
                    for key, v in tree_np.items()}
            res = {}
            for tag, cap in (("", gossip.BUCKET_BYTES), ("per-tensor ", 0)):
                mixer = _mixer_with_cap(cap, group, plan, flatten)
                rounds, combines = [], []
                for r in range(len(plan)):
                    calls.clear()
                    rounds.append(_numpy(mixer(mine, r)))
                    combines.append(len(calls))
                res.update({tag + "rounds": rounds,
                            tag + "sent": dict(mixer.stats),
                            tag + "combines": combines})
            out[(name, n, k, flatten)] = res
    finally:
        ops.gossip_mix_many = real
    return out


def compressed_mixer_rounds(rank, device, tree_np, ef_np, cases):
    """For each ``(codec, name, n, k)`` case, this rank's mixed slice and
    new EF residuals after each round of the compressed mixer (chunk 64,
    error feedback, t = the round), every round from the same inputs, with
    the mixer's bucket cap and with one bucket per reference leaf (a cap
    of 0); the messages and bytes sent, and the grouped calls each round
    made (``ops.quantize_payload_many``, ``ops.quantized_gossip_mix_many``).
    A case of n < world size runs in the subgroup of ranks 0..n-1."""
    from repro_torch.compress import CompressionConfig
    torch.set_num_threads(1)
    world = dist.get_world_size()
    groups = {n: dist.new_group(list(range(n)))
              for n in sorted({c[2] for c in cases}) if n < world}
    calls = []
    names = ("quantize_payload_many", "quantized_gossip_mix_many")
    real = _counting(names, calls)
    out = {}
    try:
        for codec, name, n, k in cases:
            if rank >= n:
                continue
            ccfg = CompressionConfig(codec=codec, chunk=64,
                                     error_feedback=True, seed=3)
            plan = build_schedule(TopologySpec(name=name, n=n,
                                               k=k)).as_ppermute_plan()
            mine = {key: torch.from_numpy(v[:n][rank:rank + 1]).to(device)
                    for key, v in tree_np.items()}
            res = {}
            for tag, cap in (("", gossip.BUCKET_BYTES), ("per-leaf ", 0)):
                mixer = _mixer_with_cap(cap, groups.get(n), plan, False,
                                        ccfg)
                rounds, made = [], []
                for r in range(len(plan)):
                    # a copy: the mixer writes the residuals in place
                    ef = {key: torch.from_numpy(v[:n][rank:rank + 1]).to(
                        device, copy=True) for key, v in ef_np.items()}
                    calls.clear()
                    mixed, ef = mixer(mine, r, ef, r)
                    rounds.append((_numpy(mixed), _numpy(ef)))
                    made.append([calls.count(c) for c in names])
                res.update({tag + "rounds": rounds,
                            tag + "sent": dict(mixer.stats),
                            tag + "calls": made})
            out[(codec, name, n, k)] = res
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)
    return out


def train(rank, device, params_np, num_blocks, compression, steps, eta, B,
          T, method="dsgdm", arch="gemma3-1b", remat=True):
    """This rank's node of ``method`` (DSGD-momentum by default) on
    reduced ``arch`` (f32) over Base-2, from the given parameters, each
    pattern block checkpointed with ``remat`` (the step's default);
    returns the final parameters, method state and losses as numpy."""
    torch.set_num_threads(1)
    cfg = get_config(arch).reduced(num_blocks=num_blocks)
    n = dist.get_world_size()
    params = node_stack({k: torch.from_numpy(v) for k, v in
                         params_np.items()}, 1, device)
    bundle = make_train_step(cfg, None, topology="base", k=1,
                             method_name=method, eta=eta,
                             param_dtype=torch.float32, remat=remat,
                             compression=compression)
    opt = bundle.method.init(params)
    losses = []
    for step in range(steps):
        raw = token_batches(step, batch=n * B, seq=T, vocab=cfg.vocab_size)
        batch = {k: v.reshape(n, B, T)[rank:rank + 1] for k, v in raw.items()}
        params, opt, loss = bundle.step_fn(params, opt, batch, step)
        losses.append(float(loss))
    state = {k: (_numpy(v) if isinstance(v, dict) else v)
             for k, v in opt.items()}
    return {"params": _numpy(params), "state": state, "losses": losses,
            "sent": dict(bundle.mixer.stats)}


def all_cases(rank, device, tree_np, mix_cases, train_cases,
              ctree=None, cmix_cases=()):
    """Every case of the test module in one spawn: the mixer cases, the
    compressed mixer cases (``ctree`` its tree and EF residuals), then
    one training run per ``(name, train arguments)`` of
    ``train_cases``."""
    out = {"mix": mixer_rounds(rank, device, tree_np, mix_cases)}
    if cmix_cases:
        out["cmix"] = compressed_mixer_rounds(rank, device, *ctree,
                                              cmix_cases)
    for name, args in train_cases:
        out[name] = train(rank, device, *args)
    return out


def card_mixer(rank, device, tree_np):
    """One round of Base-2 at n = 2 (an average) on the card, plain and
    int8-compressed, with the gossip kernels' launch counts."""
    from repro_torch.compress import CompressionConfig, init_ef
    from repro_torch.kernels.gossip_mix import (gossip_mix_slots,
                                                gossip_mix_slots_many)
    from repro_torch.kernels.quantized_gossip import (
        quantize_ef, quantize_ef_many, quantized_gossip_mix,
        quantized_gossip_mix_many)
    plan = build_schedule(TopologySpec(name="base", n=2,
                                       k=1)).as_ppermute_plan()
    mine = {k: torch.from_numpy(v[rank:rank + 1]).to(device)
            for k, v in tree_np.items()}
    ccfg = CompressionConfig(codec="int8", chunk=64)
    counters = {"gossip_mix_slots": gossip_mix_slots,
                "gossip_mix_slots_many": gossip_mix_slots_many,
                "quantize_ef": quantize_ef,
                "quantized_gossip_mix": quantized_gossip_mix,
                "quantize_ef_many": quantize_ef_many,
                "quantized_gossip_mix_many": quantized_gossip_mix_many}
    before = {k: c.launches for k, c in counters.items()}
    mixed = make_gossip_mixer(None, plan)(mine, 0)
    compressed, _ = make_gossip_mixer(None, plan, compression=ccfg)(
        mine, 0, init_ef(mine, ccfg), 0)
    torch.cuda.synchronize()
    return {"device": str(device), "mixed": _numpy(mixed),
            "compressed": _numpy(compressed),
            "launches": {k: c.launches - before[k]
                         for k, c in counters.items()}}


def fail_on_rank_one(rank, device):
    if rank == 1:
        raise ValueError("rank one fails on purpose")
    return rank
