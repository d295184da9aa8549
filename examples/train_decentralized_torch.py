"""End-to-end example on the PyTorch port: decentralized training of a
transformer LM with the Base-(k+1) gossip schedule over a (data, model)
mesh of local gloo ranks (the port of ``examples/train_decentralized.py``:
the production path, ``dist.steps.make_train_step(mesh=)``, not the
simulator).

The default preset trains a ~1.5M-param granite-family model on 8 ranks as
a (4, 2) mesh (4 gossip nodes, each split over 2 model ranks) for 200
steps; ``--preset 100m`` uses a ~100M model.

    PYTHONPATH=src python examples/train_decentralized_torch.py \
        [--preset tiny|100m] [--steps 200] [--topology base --k 1] \
        [--nproc 8] [--device cpu]

Runs on the card unless ``--device cpu`` is given (the ranks then share
it through gloo).
"""
import argparse
from dataclasses import replace

import numpy as np
import torch


def _cfg(preset):
    from repro_torch.configs import get_config
    from repro_torch.configs.common import LayerSpec

    base = get_config("granite-8b")
    if preset == "tiny":
        return replace(base, d_model=128, num_heads=4, num_kv_heads=2,
                       head_dim=32, d_ff=512, vocab_size=4096, num_blocks=4,
                       pattern=(LayerSpec(kind="attn", ffn="dense"),)), \
            16, 64, 0.02
    return replace(base, d_model=768, num_heads=12, num_kv_heads=4,
                   head_dim=64, d_ff=2048, vocab_size=16384, num_blocks=10,
                   pattern=(LayerSpec(kind="attn", ffn="dense"),)), \
        8, 256, 0.01


def _rank(rank, device, args):
    """One rank of the mesh: its shards of node-stacked parameters, its
    node's rows of each step's batch; returns its node and losses."""
    from repro_torch.convert import shard_for_rank
    from repro_torch.data.synthetic import token_batches
    from repro_torch.dist.sharding import param_partition_specs
    from repro_torch.dist.steps import make_train_step
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.sim.engine import node_stack

    if device.type == "cpu":
        torch.set_num_threads(1)
    cfg, batch, seq, eta = _cfg(args.preset)
    mesh = make_host_mesh(model=2)
    bundle = make_train_step(cfg, mesh=mesh, topology=args.topology,
                             k=args.k, method_name=args.method, eta=eta,
                             param_dtype=torch.float32, remat=False)
    n, node = bundle.n_nodes, bundle.node
    b = batch // n
    full = M.init(cfg, seed=0, dtype=torch.float32, device="cpu")
    count = sum(p.numel() for p in full.parameters())
    full = full.state_dict()
    params = node_stack(shard_for_rank(full, param_partition_specs(
        full, bundle.rules), mesh, mesh.coords), 1, device)
    del full
    opt = bundle.method.init(params)

    def mk_batch(step):
        raw = token_batches(step, batch=n * b, seq=seq,
                            vocab=cfg.vocab_size, seed=3)
        return {kk: torch.from_numpy(v.reshape(n, b, seq)[node:node + 1])
                .to(device) for kk, v in raw.items()}

    losses = []
    for step in range(args.steps):
        params, opt, loss = bundle.step_fn(params, opt, mk_batch(step), step)
        losses.append(float(loss))
    return {"node": node, "model": mesh.coords["model"], "losses": losses,
            "n": n, "count": count, "spec": bundle.spec.to_json(),
            "label": bundle.spec.label, "rounds": bundle.n_rounds}


def main():
    from repro_torch.launch.distributed import spawn_local

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=["tiny", "100m"], default="tiny")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--topology", default="base",
                    help="registered topology name or inline JSON "
                         "TopologySpec")
    ap.add_argument("--k", type=int, default=1)
    ap.add_argument("--method", default="dsgdm")
    ap.add_argument("--nproc", type=int, default=8,
                    help="ranks, laid out as (nproc // 2, 2)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    try:
        ranks = spawn_local(_rank, args.nproc, args=(args,), backend="gloo",
                            device=args.device, timeout=3000)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"error: {e}") from None
    r0 = ranks[0]
    print(f"arch=granite-family ({r0['count'] / 1e6:.1f}M params)  "
          f"nodes={r0['n']}  mesh=({args.nproc // 2}, 2)  "
          f"topology={r0['label']} spec={r0['spec']} ({r0['rounds']} "
          f"rounds)  method={args.method}  device={args.device}")
    # each node's loss, from the rank of model coordinate 0 (its model
    # ranks hold the same loss), averaged over the nodes
    per_node = {r["node"]: r["losses"] for r in ranks if r["model"] == 0}
    losses = np.mean([per_node[i] for i in sorted(per_node)], axis=0)
    for step, loss in enumerate(losses):
        if step % 20 == 0 or step == args.steps - 1:
            print(f"  step {step:4d}  loss {loss:.4f}")
    print(f"loss first-10 {np.mean(losses[:10]):.4f} -> "
          f"last-10 {np.mean(losses[-10:]):.4f}")
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    print("OK: loss decreased under decentralized gossip training.")


if __name__ == "__main__":
    main()
