"""Small MLP classifier, the paper's workload for Sec. 6.2 (port of
``repro/models/mlp.py``).

Parameters are a flat dict of tensors keyed by the reference's tree
paths (``l0.w``, ``l0.b``, ...), the layout the simulation engine and
the decentralized methods take.  ``l<i>.w`` is ``(d_in, d_out)`` and is
applied as ``x @ w + b``, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_mlp import MLPConfig
from repro_torch.device import resolve_device


def init(cfg: MLPConfig, seed: int = 0, device=None) -> dict:
    """He-normal weights and zero biases in f32, drawn from a seeded
    ``torch.Generator`` on ``device`` (CUDA unless asked).  The numbers
    differ from the reference's ``jax.random`` draws; parity runs carry
    the reference's weights across with ``convert.tree_from_jax``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dims = (cfg.input_dim,) + tuple(cfg.hidden) + (cfg.num_classes,)
    params = {}
    for i in range(len(dims) - 1):
        params[f"l{i}.w"] = torch.randn(
            dims[i], dims[i + 1], generator=gen,
            device=dev) * (2.0 / dims[i]) ** 0.5
        params[f"l{i}.b"] = torch.zeros(dims[i + 1], device=dev)
    return params


def apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    n = sum(1 for k in params if k.endswith(".w"))
    for i in range(n):
        x = x @ params[f"l{i}.w"] + params[f"l{i}.b"]
        if i < n - 1:
            x = F.relu(x)
    return x


def loss_fn(params: dict, batch) -> torch.Tensor:
    x, y = batch
    logp = F.log_softmax(apply(params, x), dim=-1)
    return -logp.gather(-1, y.long()[:, None])[:, 0].mean()


def accuracy(params: dict, x, y) -> torch.Tensor:
    return (apply(params, x).argmax(-1) == y).float().mean()
