"""Plain (per-node local) optimizers (port of ``repro/optim/sgd.py``),
over flat dicts of tensors, in plain PyTorch: the reference calls no
kernel here either."""
from __future__ import annotations

import torch


def momentum_init(params: dict) -> dict:
    return {k: torch.zeros_like(p) for k, p in params.items()}


def momentum_update(params: dict, grads: dict, mom: dict, *, eta: float,
                    beta: float = 0.9):
    """Heavy-ball: u <- beta u + g;  x <- x - eta u.  (The fused DSGD
    kernel, ``ops.fused_dsgd_step``, implements exactly this pair on the
    card.)"""
    mom = {k: beta * u + grads[k] for k, u in mom.items()}
    params = {k: x - eta * mom[k] for k, x in params.items()}
    return params, mom


def adamw_init(params: dict) -> dict:
    z = {k: torch.zeros_like(p, dtype=torch.float32)
         for k, p in params.items()}
    return {"m": z, "v": {k: torch.zeros_like(t) for k, t in z.items()},
            "t": 0}


def adamw_update(params: dict, grads: dict, state: dict, *, eta: float,
                 b1=0.9, b2=0.999, eps=1e-8, wd=0.0):
    """AdamW with bias correction; ``state["t"]`` counts the steps (an
    int, the reference's int32 scalar).  The bias corrections are taken
    in f32, as the reference's ``b ** t.astype(float32)``."""
    t = state["t"] + 1
    m = {k: b1 * mm + (1 - b1) * grads[k] for k, mm in state["m"].items()}
    v = {k: b2 * vv + (1 - b2) * grads[k] * grads[k]
         for k, vv in state["v"].items()}
    f32 = torch.float32
    bc1 = 1 - torch.tensor(b1, dtype=f32) ** torch.tensor(t, dtype=f32)
    bc2 = 1 - torch.tensor(b2, dtype=f32) ** torch.tensor(t, dtype=f32)
    params = {k: p - eta * ((m[k] / bc1.to(m[k].device))
                            / (torch.sqrt(v[k] / bc2.to(v[k].device)) + eps)
                            + wd * p)
              for k, p in params.items()}
    return params, {"m": m, "v": v, "t": t}
