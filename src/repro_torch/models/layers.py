"""Primitive layers (port of ``repro/models/layers.py``).

Weights keep the reference's orientation — ``Dense.w`` is
``(d_in, d_out)`` and is applied as ``x @ w`` — so carrying weights
across is a copy, never a transpose.  Parameter names follow the
reference's pytree keys, so a module's ``state_dict`` keys are the
reference's tree paths.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def normal_(t: torch.Tensor, generator: torch.Generator,
            scale: float = 0.02) -> torch.Tensor:
    """N(0, scale) drawn in f32, then cast (``layers.py:8-10``)."""
    with torch.no_grad():
        t.copy_(scale * torch.randn(t.shape, generator=generator,
                                    device=t.device, dtype=torch.float32))
    return t


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Gemma-style (1 + scale) RMSNorm in f32, cast back to x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, dtype, device):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(d, dtype=dtype, device=device),
                                  requires_grad=False)

    def forward(self, x):
        return rmsnorm(x, self.scale)


# ---------------------------------------------------------------------------
# linear / embedding
# ---------------------------------------------------------------------------

class Dense(nn.Module):
    """``x @ w`` (+ ``b``): with ``bias`` a zero-initialised ``b`` of shape
    ``(d_out,)``, added after the product (``dense_init(..., bias=True)``,
    ``layers.py:33-43``).  ``tp`` is set on a tensor-parallel rank whose
    ``w`` is a shard (``repro_torch.dist.tp``), and None otherwise."""

    tp = None

    def __init__(self, d_in: int, d_out: int, *, dtype, device,
                 bias: bool = False):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out, dtype=dtype,
                                          device=device), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(d_out, dtype=dtype, device=device),
                              requires_grad=False) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.w, generator)

    def forward(self, x):
        if self.tp is not None:
            return self.tp.dense(self, x)
        y = x @ self.w
        if self.b is not None:     # a second rounding, as the reference's
            y = y + self.b
        return y


class Embed(nn.Module):
    """The token table (vocab, d); ``tp`` as :class:`Dense`'s."""

    tp = None

    def __init__(self, vocab: int, d: int, *, dtype, device):
        super().__init__()
        self.table = nn.Parameter(torch.empty(vocab, d, dtype=dtype,
                                              device=device),
                                  requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.table, generator)

    def forward(self, tokens):
        if self.tp is not None:
            return self.tp.embed(self, tokens)
        return self.table[tokens]


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, d: int, d_ff: int, *, act: str, dtype, device):
        super().__init__()
        self.act = act
        self.gate = Dense(d, d_ff, dtype=dtype, device=device)
        self.up = Dense(d, d_ff, dtype=dtype, device=device)
        self.down = Dense(d_ff, d, dtype=dtype, device=device)

    def forward(self, x):
        g = self.gate(x)
        g = F.silu(g) if self.act == "silu" else F.gelu(g, approximate="tanh")
        return self.down(g * self.up(x))


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x: (..., T, H, hd) rotated by absolute positions, (T,) shared or
    (B, T) per slot — half-split layout with f32 angles, as
    ``layers.py:76-88``."""
    hd = x.shape[-1]
    half = hd // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=x.device), -idx / half)
    ang = positions[..., None].float() * freq            # (..., T, half)
    cos = torch.cos(ang)[..., None, :]                    # (..., T, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def chunked_ce_loss(h: torch.Tensor, w_out: torch.Tensor,
                    labels: torch.Tensor, chunk: int = 512,
                    logit_softcap: float | None = None, *, project=None,
                    reduce=None) -> torch.Tensor:
    """Cross-entropy without materialising the full (B, T, V) logits:
    a loop over T-chunks, each chunk's logits in f32
    (``layers.py:95-128``).

    h: (B, T, D); w_out: (D, V); labels: (B, T) with -100 = ignore.
    Returns the mean over the labelled positions.  On a tensor-parallel
    rank (``repro_torch.dist.tp``) ``project`` takes a chunk of ``h`` to
    its f32 logits in place of ``w_out``, and ``reduce`` adds the summed
    losses and the count over the ranks that hold other rows of the
    batch before the mean."""
    T = h.shape[1]
    chunk = min(chunk, T)
    if project is None:
        w = w_out.float()           # one f32 copy for every chunk

        def project(hc):
            return hc.float() @ w
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.int64, device=h.device)
    for t0 in range(0, T, chunk):
        logits = project(h[:, t0:t0 + chunk])
        if logit_softcap is not None:
            logits = logit_softcap * torch.tanh(logits / logit_softcap)
        li = labels[:, t0:t0 + chunk].long()
        valid = li != -100
        tgt = torch.where(valid, li, 0)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, tgt[..., None])[..., 0]
        tot = tot + torch.where(valid, lse - gold, 0.0).sum()
        cnt = cnt + valid.sum()
    if reduce is not None:
        tot, cnt = reduce(tot, cnt)
    return tot / cnt.clamp_min(1)
