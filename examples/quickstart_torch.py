"""Quickstart on the PyTorch port: build a Base-(k+1) graph, verify
finite-time consensus, and run a short decentralized training demo on
synthetic data (the port of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Runs on the card unless ``--device cpu`` is given (DSGD-momentum's
update through the fused CUDA kernel there, its plain version here).
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.paper_mlp import MLPConfig
from repro_torch.core.mixing import consensus_error_curve
from repro_torch.data.synthetic import dirichlet_classification
from repro_torch.device import resolve_device
from repro_torch.models import mlp
from repro_torch.optim.decentralized import make_method
from repro_torch.sim.engine import simulate_decentralized
from repro_torch.topology import TopologySpec, build_schedule


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=150)
    args = ap.parse_args()
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from None

    # --- 1. the paper's object: a finite-time convergent schedule -------
    n, k = 21, 2
    spec = TopologySpec(name="base", n=n, k=k)
    sched = build_schedule(spec)
    print(f"Base-{k + 1} graph, spec {sched.spec.to_json()}: "
          f"{len(sched)} rounds, max degree {sched.max_degree} "
          f"(bound 2*log_{k + 1}({n})+2 = "
          f"{2 * np.log(n) / np.log(k + 1) + 2:.1f})")
    errs = consensus_error_curve(sched, len(sched), seed=0, d=8)
    for r, e in enumerate(errs):
        bar = "#" * max(0, int(40 + 2 * np.log10(max(e, 1e-40))))
        print(f"  round {r:2d}  consensus err {e:10.3e}  {bar}")
    print("  -> exact consensus after the finite schedule. Compare ring:")
    ring = consensus_error_curve(
        build_schedule(TopologySpec(name="ring", n=n)), len(sched),
        seed=0, d=8)
    print(f"  ring error after {len(sched)} rounds: {ring[-1]:.3e}")
    assert errs[-1] < 1e-20 < ring[-1]

    # --- 2. decentralized training under data heterogeneity -------------
    cfg = MLPConfig(input_dim=32, hidden=(64,), num_classes=10)
    data = dirichlet_classification(n, 256, dim=32, num_classes=10,
                                    alpha=0.1, margin=1.5, seed=0)
    params = mlp.init(cfg, seed=0, device=dev)
    test_x = torch.from_numpy(data.test_x).to(dev)
    test_y = torch.from_numpy(data.test_y).to(dev)

    def batches(step, bs=32):
        i = (step * bs) % (256 - bs)
        return data.node_x[:, i:i + bs], data.node_y[:, i:i + bs]

    def eval_fn(p):
        return mlp.accuracy(p, test_x, test_y)

    print(f"\nDSGD-momentum, n={n} nodes, Dirichlet alpha=0.1, on {dev}:")
    for name, kk in (("base", 2), ("exp", None), ("ring", None)):
        sp = TopologySpec(name=name, n=n, k=kk)
        s = build_schedule(sp)
        res = simulate_decentralized(
            loss_fn=mlp.loss_fn, params=params, method=make_method("dsgdm"),
            schedule=sp, batches=batches, steps=args.steps, eta=0.03,
            eval_fn=eval_fn, eval_every=args.steps - 1, device=dev)
        print(f"  {sp.label:10s} "
              f"maxdeg={s.max_degree}  acc={res.test_acc[-1]:.3f}  "
              f"consensus={res.consensus[-1]:.2e}")
        assert np.all(np.isfinite(res.losses))
    print("OK")


if __name__ == "__main__":
    main()
