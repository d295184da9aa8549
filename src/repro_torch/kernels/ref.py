"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

Each is the port of the matching oracle in ``repro/kernels/ref.py`` and
computes what its CUDA kernel computes.  ``ops`` sends CPU tensors here;
``chip_smoke.py`` holds each kernel against its plain version on the
card.  They repeat the kernels' arithmetic in f32 and are no yardstick
of speed.
"""
from __future__ import annotations

import torch

_NEG_INF = -1e30


def fused_dsgd_ref(x, u, g, beta: float, eta: float, pre_scale=1.0):
    """Fused heavy-ball momentum + SGD step, with the gossip self-weight
    pre-scale (``ref.py:29-46``), the plain version of the fused DSGD
    kernel:

        u' = beta * u + g
        x' = pre_scale * (x - eta * u')

    in f32, cast back to x's and u's dtypes.  ``pre_scale`` is a scalar
    or a tensor broadcastable against ``x`` (per-node self-weights arrive
    shaped ``(n, 1, ..., 1)``).  Each line is one PyTorch op, so nothing
    fuses into an FMA, and the kernel's rounding steps are these."""
    xf, uf, gf = x.float(), u.float(), g.float()
    if isinstance(pre_scale, torch.Tensor):
        pre_scale = pre_scale.float()
    u_new = beta * uf + gf
    x_new = pre_scale * (xf - eta * u_new)
    return x_new.to(x.dtype), u_new.to(u.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None,
                        softcap=None, scale=None):
    """Plain-softmax attention oracle (``ref.py:49-78``).

    q: (B, H, Tq, D);  k, v: (B, H, Tk, D) — callers handling GQA
    broadcast the kv heads first.  Key j attends to query i iff
    ``i - window < j <= i`` (when causal), the last query aligned to the
    last key; fully masked rows give zeros."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qi = torch.arange(Tq, device=q.device)[:, None] + (Tk - Tq)
    kj = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(logits - m)
    p = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def grouped_sdpa_ref(q, k, v, *, causal: bool = True, window=None,
                     softcap=None, scale=None, q_pos0=None,
                     k_valid_len=None):
    """Grouped-query attention in the model stack's layout — the plain
    version of the flash-attention kernel (``ref.py:81-141``).

    q: (B, Tq, H, hd);  k, v: (B, S, KV, hd[, hd_v]) with H % KV == 0;
    query head h reads kv head h // (H // KV).  Query i sits at absolute
    position ``q_pos0 + i`` (default ``S - Tq``; a scalar, or a (B,)
    tensor of per-batch starts).  ``k_valid_len`` (int or (B,)) is the
    valid cache prefix.  Value rows at or past it are zeroed before the
    accumulate, as the kernel does, so garbage in the cache tail never
    reaches the output.  Masked logits are -1e30 (not -inf) and the
    denominator is clamped at 1e-30, as in the reference.
    """
    B, Tq, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    G = H // KV
    dev = q.device
    if scale is None:
        scale = hd ** -0.5
    if q_pos0 is None:
        q_pos0 = S - Tq
    q_pos0 = torch.as_tensor(q_pos0, device=dev).reshape(-1, 1)   # (1|B, 1)
    qpos = q_pos0 + torch.arange(Tq, device=dev)                  # (1|B, Tq)
    kpos = torch.arange(S, device=dev)
    m = torch.ones((qpos.shape[0], Tq, S), dtype=torch.bool, device=dev)
    if causal:
        m &= kpos[None, None, :] <= qpos[:, :, None]
    if window is not None:
        m &= kpos[None, None, :] > qpos[:, :, None] - window
    kf, vf = k.float(), v.float()
    if k_valid_len is not None:
        valid = kpos[None, :] < torch.as_tensor(
            k_valid_len, device=dev).reshape(-1, 1)               # (1|B, S)
        m = m & valid[:, None, :]
        keep = valid[:, :, None, None]
        kf = torch.where(keep, kf, 0.0)
        vf = torch.where(keep, vf, 0.0)
    qg = q.float().reshape(B, Tq, KV, G, hd)
    logits = torch.einsum("btkgd,bskd->btkgs", qg, kf) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(m[:, :, None, None, :], logits, _NEG_INF)
    mx = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - mx)
    out = torch.einsum("btkgs,bskd->btkgd", p, vf)
    den = p.sum(dim=-1).clamp_min(1e-30)
    out = out / den[..., None]
    return out.reshape(B, Tq, H, hd_v).to(q.dtype)
