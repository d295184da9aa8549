"""Batched serving on the PyTorch port: prefill + generation with the KV
cache and the weights sharded over a (data 4, model 2) mesh of 8 gloo
ranks, using a reduced gemma3 (sliding-window + global attention, MQA)
model (the port of ``examples/serve_batched.py``).

Each rank draws the whole model from seed 0 on the CPU, keeps its shard
under the serve rules (``convert.shard_for_rank``) and serves its rows
through ``serve.make_engine(mesh=)``; greedy and sampled tokens of every
row are checked against the one-rank engine's on the same weights.

    PYTHONPATH=src python examples/serve_batched_torch.py [--device cpu]

Runs on the card unless ``--device cpu`` is given (the 8 ranks then
share it through gloo).
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.serve import SamplingParams, make_engine

B, PROMPT, GEN, MESH = 8, 24, 12, (4, 2)
SAMPLINGS = (SamplingParams(),  # greedy
             SamplingParams(mode="sample", temperature=0.8, top_k=40))


def _rank(rank, device):
    """One rank: its shard, its rows, both samplings twice (first call,
    then steady state); returns its first row and the tokens."""
    from repro_torch.convert import shard_for_rank
    from repro_torch.dist.sharding import (batch_partition_specs,
                                           make_rules,
                                           param_partition_specs)
    from repro_torch.dist.tp import bind
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    mesh = make_host_mesh(model=MESH[1])
    cfg = get_config("gemma3-1b").reduced()
    rules = make_rules(mesh, arch_name=cfg.name, context="serve")
    full = M.init(cfg, seed=0, dtype=torch.float32, device="cpu")
    full = full.state_dict()
    model = bind(cfg, {k: v.to(device) for k, v in shard_for_rank(
        full, param_partition_specs(full, rules), mesh,
        mesh.coords).items()}, mesh)
    batch = {"tokens": _prompts(cfg).to(device)}
    mine = shard_for_rank(batch, batch_partition_specs(
        batch, rules, node_stacked=False), mesh, mesh.coords)
    out = {"coords": mesh.coords, "runs": []}
    for sampling in SAMPLINGS:
        engine = make_engine(cfg, batch=B, prompt_len=PROMPT, max_new=GEN,
                             sampling=sampling, param_dtype=torch.float32,
                             cache_dtype=torch.float32, device=device,
                             mesh=mesh)
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            tokens, _ = engine.generate(model, mine, seed=2)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t0)
        out["row0"] = engine.row0
        out["runs"].append((sampling.mode, times, tokens.cpu().tolist()))
    return out


def _prompts(cfg):
    gen = torch.Generator().manual_seed(1)
    return torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen)


def main():
    from repro_torch.device import resolve_device
    from repro_torch.launch.distributed import spawn_local

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from None
    ranks = spawn_local(_rank, MESH[0] * MESH[1], backend="gloo",
                        device=args.device, timeout=600)
    cfg = get_config("gemma3-1b").reduced()
    # the ranks' draw: on the CPU, then moved
    params = M.init(cfg, seed=0, dtype=torch.float32, device="cpu").to(dev)
    batch = {"tokens": _prompts(cfg).to(dev)}
    print(f"reduced gemma3-1b on a (data {MESH[0]}, model {MESH[1]}) mesh "
          f"of {len(ranks)} gloo ranks on {dev}")
    for i, sampling in enumerate(SAMPLINGS):
        one = make_engine(cfg, batch=B, prompt_len=PROMPT, max_new=GEN,
                          sampling=sampling, param_dtype=torch.float32,
                          cache_dtype=torch.float32, device=dev)
        want = one.generate(params, batch, seed=2)[0].cpu().tolist()
        rows = {}
        for r in ranks:
            mode, times, tokens = r["runs"][i]
            for j, row in enumerate(tokens):
                rows.setdefault(r["row0"] + j, row)
                assert row == want[r["row0"] + j], (mode, r["coords"], j)
        t_first, dt = ranks[0]["runs"][i][1]
        print(f"[{SAMPLINGS[i].mode}] {GEN} tokens x {B} seqs: rank 0 "
              f"first call {t_first:.2f}s, steady {dt:.3f}s "
              f"({len(tokens) * GEN / dt:.0f} tok/s on its "
              f"{len(tokens)} rows); every row equals the one-rank "
              f"engine's")
        for r in range(min(4, B)):
            print("  seq", r, rows[r])
    print("OK")


if __name__ == "__main__":
    main()
