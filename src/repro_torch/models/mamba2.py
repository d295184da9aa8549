"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060), chunked form
(port of ``repro/models/mamba2.py``).

Training and prefill run the chunked SSD algorithm: intra-chunk
"attention" with cumulative decay, then the chunk states carried from
chunk to chunk (a Python loop in place of the reference's ``lax.scan``),
O(T * chunk) work and an f32 ``(b, h, p, n)`` state between chunks.
Decode is the O(1) recurrent step on that state.  The reference has no
Pallas kernel here: its scan is plain ``einsum``s, and so is the port's.

Two places where the port computes differently from the reference:

* **The decay is masked before the exponent.**  The reference takes
  ``exp(cs_t - cs_j)`` for every pair and zeroes ``t < j`` afterwards
  (``mamba2.py:66-67``); for ``t < j`` the exponent is positive, and once
  a chunk's decay sum passes ~88 it overflows f32 and the backward
  multiplies a zero cotangent by ``inf``: its ``dL/d dt`` is NaN.  The
  port takes ``exp(where(t >= j, cs_t - cs_j, -inf))``, the paper's
  ``segsum``: the same forward bits (``exp(-inf)`` is exactly 0) and
  finite gradients.
* **The contraction order.**  ``einsum("btj,btjh,bjhp->bthp")`` as one
  product would build ``(b, t, j, h, p)``; the port forms ``CB * L`` as
  ``(b, t, j, h)`` first, then one batched product over ``(b, h)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.common import SSMConfig

from .layers import Dense, RMSNorm, normal_


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssd_chunked(x, dt, A, B, C, chunk: int, init_state=None):
    """x: (b, t, h, p); dt: (b, t, h) (post-softplus); A: (h,) negative;
    B, C: (b, t, n).  Returns (y: (b, t, h, p) in x's dtype, final_state:
    (b, h, p, n) f32).  ``t`` must be a multiple of ``min(chunk, t)``.

    Recurrence: s_t = exp(dt_t A) s_{t-1} + dt_t B_t x_t;  y_t = C_t . s_t
    """
    b, t, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, t)
    if t % q:
        raise ValueError(f"sequence length {t} is not a multiple of the SSD "
                         f"chunk {q}")
    xd = (x * dt[..., None]).float()                     # (b, t, h, p)
    dA = (dt * A).float()                                # (b, t, h) <= 0
    Bf, Cf = B.float(), C.float()
    tri = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    S = torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device) \
        if init_state is None else init_state.float()
    ys = []
    for c0 in range(0, t, q):
        xd_c, B_c, C_c = xd[:, c0:c0 + q], Bf[:, c0:c0 + q], Cf[:, c0:c0 + q]
        cs = torch.cumsum(dA[:, c0:c0 + q], dim=1)       # (b, q, h)
        total = cs[:, -1]                                # (b, h)
        # intra-chunk: L[t, j] = exp(cs_t - cs_j) for t >= j, masked first
        seg = cs[:, :, None, :] - cs[:, None, :, :]      # (b, t, j, h)
        L = torch.exp(torch.where(tri[None, :, :, None], seg,
                                  float("-inf")))
        CB = C_c @ B_c.transpose(1, 2)                   # (b, t, j)
        M = (CB[..., None] * L).permute(0, 3, 1, 2)      # (b, h, t, j)
        y = (M @ xd_c.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)  # (b,t,h,p)
        # inter-chunk contribution from the carried state
        y = y + (C_c @ S.reshape(b, h * p, n).transpose(1, 2)).reshape(
            b, q, h, p) * torch.exp(cs)[..., None]
        # the chunk's state
        decay_out = torch.exp(total[:, None, :] - cs)    # (b, q, h)
        S_loc = ((xd_c * decay_out[..., None]).reshape(b, q, h * p)
                 .transpose(1, 2) @ B_c).reshape(b, h, p, n)
        S = torch.exp(total)[..., None, None] * S + S_loc
        ys.append(y)
    return torch.cat(ys, dim=1).to(x.dtype), S


def ssd_step(S, x, dt, A, B, C):
    """One decode step.  S: (b, h, p, n); x: (b, h, p); dt: (b, h); B, C:
    (b, n).  Returns (S_new in S's dtype, y (b, h, p) in x's dtype)."""
    Sf = S.float()
    dA = torch.exp((dt * A).float())                     # (b, h)
    S_new = dA[..., None, None] * Sf + (x * dt[..., None]).float()[
        ..., None] * B.float()[:, None, None, :]
    y = (S_new @ C.float()[:, None, :, None])[..., 0]
    return S_new.to(S.dtype), y.to(x.dtype)


def causal_depthwise_conv(x, w, b):
    """x: (B, T, C); w: (K, C); the left-padded causal depthwise conv, a
    cross-correlation as ``lax.conv_general_dilated`` (``w`` not flipped),
    plus ``b``."""
    K, C = w.shape
    xp = F.pad(x.transpose(1, 2), (K - 1, 0))            # (B, C, K-1+T)
    out = F.conv1d(xp, w.T[:, None, :], groups=C)        # (B, C, T)
    return out.transpose(1, 2) + b


# ---------------------------------------------------------------------------
# Mamba-2 block
# ---------------------------------------------------------------------------

class Mamba(nn.Module):
    """``mamba_init`` / ``mamba_apply``: the input projection split into z,
    xBC and dt; the causal conv and SiLU on xBC; the SSD scan (or, with a
    cache and one token, its step); the ``D`` skip; the gated RMSNorm
    ``norm(y * silu(z))`` in f32; the output projection.  On a
    tensor-parallel rank (``tp`` set, ``repro_torch.dist.tp``) ``conv_w``
    is gathered whole where it is used."""

    tp = None

    def __init__(self, d_model: int, cfg: SSMConfig, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        d_in, h = cfg.d_inner(d_model), cfg.nheads(d_model)
        self.d_in, self.h = d_in, h
        conv_dim = d_in + 2 * cfg.d_state
        self.in_proj = Dense(d_model, 2 * d_in + 2 * cfg.d_state + h, **kw)

        def param(fill, *shape):
            return nn.Parameter(torch.full(shape, fill, **kw),
                                requires_grad=False)

        self.conv_w = param(0.0, cfg.d_conv, conv_dim)
        self.conv_b = param(0.0, conv_dim)
        self.A_log = param(0.0, h)             # A = -exp(A_log) = -1
        self.D = param(1.0, h)
        self.dt_bias = param(0.0, h)
        self.norm = RMSNorm(d_in, **kw)
        self.out_proj = Dense(d_in, d_model, **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """``conv_w`` N(0, 0.1), as ``mamba_init``; the projections are
        :class:`Dense` and draw their own, and the other leaves keep
        their construction values (``D`` 1, the rest 0)."""
        normal_(self.conv_w, generator, 0.1)

    def forward(self, x, cache=None):
        """x: (B, T, D).  ``cache = {"conv": (B, K-1, conv_dim), "ssm": (B,
        h, p, n) f32}`` is read and then updated in place (T = 1 takes
        the step, T > 1 continues the chunked scan from its state).
        Returns y (B, T, D)."""
        cfg = self.cfg
        B_, T, _ = x.shape
        d_in, h, n = self.d_in, self.h, cfg.d_state
        proj = self.in_proj(x)
        z = proj[..., :d_in]
        xbc = proj[..., d_in:2 * d_in + 2 * n]
        dt = proj[..., 2 * d_in + 2 * n:]
        conv_w = self.conv_w if self.tp is None else self.tp.whole(
            self, "conv_w")
        if cache is None:
            xbc = causal_depthwise_conv(xbc, conv_w, self.conv_b)
        else:
            # the rolling conv history, kept in the cache's dtype
            hist = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)
            xbc = causal_depthwise_conv(hist, conv_w, self.conv_b)[:, -T:]
            conv_new = hist[:, -(cfg.d_conv - 1):]
        xbc = F.silu(xbc)
        xs = xbc[..., :d_in].reshape(B_, T, h, cfg.headdim)
        Bm = xbc[..., d_in:d_in + n]
        Cm = xbc[..., d_in + n:]
        dt = F.softplus(dt.float() + self.dt_bias.float())
        A = -torch.exp(self.A_log.float())
        if cache is not None and T == 1:
            S, y = ssd_step(cache["ssm"], xs[:, 0], dt[:, 0], A, Bm[:, 0],
                            Cm[:, 0])
            y = y[:, None]
        else:
            y, S = ssd_chunked(xs, dt, A, Bm, Cm, cfg.chunk,
                               None if cache is None else cache["ssm"])
        if cache is not None:
            cache["conv"].copy_(conv_new)
            cache["ssm"].copy_(S)
        y = y + self.D.to(y.dtype)[None, None, :, None] * xs
        y = y.reshape(B_, T, d_in)
        # gated RMSNorm (mamba2): norm(y * silu(z)), all in f32
        g = y.float() * F.silu(z.float())
        return self.out_proj(self.norm(g).to(x.dtype))


def mamba_cache_init(batch: int, d_model: int, cfg: SSMConfig, dtype,
                     device) -> dict:
    """A Mamba layer's decode state (``mamba2.py:181-189``): the conv
    history in ``dtype``, the SSM state in f32."""
    d_in, h = cfg.d_inner(d_model), cfg.nheads(d_model)
    conv_dim = d_in + 2 * cfg.d_state
    return {
        "conv": torch.zeros(batch, cfg.d_conv - 1, conv_dim, dtype=dtype,
                            device=device),
        "ssm": torch.zeros(batch, h, cfg.headdim, cfg.d_state,
                           dtype=torch.float32, device=device),
    }
