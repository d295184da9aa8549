"""Plain float32 reference of seamless-m4t-large-v2 (arXiv:2308.11596) as
the benchmark trains it: a pre-norm transformer encoder over stub audio
frames and a decoder with cross-attention, the tied output projection,
next-token cross-entropy; and the decentralized step it is trained by,
DSGD with heavy-ball momentum over the Base-(k+1) rounds.

Layer equations (every norm ``x / rms(x) * (1 + scale)``, eps 1e-6):

    encoder layer:  x += Wo attn(rope(Wq n1(x)), rope(Wk n1(x)), Wv n1(x))
                    x += W_down (gelu(W_gate n2(x)) * W_up n2(x))
                    (no mask; after the last layer, the encoder's norm)
    decoder layer:  the same self-attention, causal, then
                    x += Wo' attn(Wq' nx(x), Wk' enc, Wv' enc)   (no rope)
                    then the feed-forward
    head:           logits = n_f(x) @ E^T;  loss = mean CE over labels

gelu is the tanh form.  DSGD-momentum, node i, round r (matrix W_r):

    u_i <- beta u_i + g_i;   x_i <- sum_j W_r[i, j] (x_j - eta u_j)

in float32, with what the configuration stores (bfloat16 parameters and
momentum) rounded to it where it is stored: u_i after its update, x_j -
eta u_j (the payload exchanged) and x_i after the mix.

Weights arrive as a flat dict keyed by the port's parameter names (the
benchmark draws them; this file reads them by name and imports nothing
of the port).  Each layer runs under activation checkpointing, and the
head's cross-entropy chunk by chunk, so the nodes' stored parameters and
momentum fit on one card beside one node's float32 copy and gradient.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import torch
from torch.utils.checkpoint import checkpoint

_spec = importlib.util.spec_from_file_location(
    "perfbench_reference_plain", Path(__file__).with_name("_plain.py"))
P = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(P)


def _self_attn(pr, w, pre, x, causal):
    B, T, _ = x.shape
    H, KV, hd = w["_H"], w["_KV"], w["_hd"]
    pos = torch.arange(T, device=x.device)
    mask = P.causal_mask(T, T, x.device) if causal else \
        torch.ones(T, T, dtype=torch.bool, device=x.device)
    outs = []
    for b in range(B):
        q = P.rope(pr.mm(x[b], w[pre + "wq.w"]).reshape(T, H, hd), pos)
        k = P.rope(pr.mm(x[b], w[pre + "wk.w"]).reshape(T, KV, hd), pos)
        v = pr.mm(x[b], w[pre + "wv.w"]).reshape(T, KV, hd)
        outs.append(pr.mm(P.attend(pr, q, k, v, mask).reshape(T, H * hd),
                          w[pre + "wo.w"]))
    return torch.stack(outs)


def _cross_attn(pr, w, pre, x, enc):
    B, T, _ = x.shape
    S = enc.shape[1]
    H, KV, hd = w["_H"], w["_KV"], w["_hd"]
    mask = torch.ones(T, S, dtype=torch.bool, device=x.device)
    outs = []
    for b in range(B):
        q = pr.mm(x[b], w[pre + "wq.w"]).reshape(T, H, hd)
        k = pr.mm(enc[b], w[pre + "wk.w"]).reshape(S, KV, hd)
        v = pr.mm(enc[b], w[pre + "wv.w"]).reshape(S, KV, hd)
        outs.append(pr.mm(P.attend(pr, q, k, v, mask).reshape(T, H * hd),
                          w[pre + "wo.w"]))
    return torch.stack(outs)


def _ffn(pr, w, pre, x):
    return P.gated_ffn(pr, x, w[pre + "gate.w"], w[pre + "up.w"],
                       w[pre + "down.w"])


def _enc_layer(pr, w, pre, x):
    x = x + _self_attn(pr, w, pre + "attn.", P.rmsnorm(x, w[pre + "ln1.scale"]),
                       causal=False)
    return x + _ffn(pr, w, pre + "mlp.", P.rmsnorm(x, w[pre + "ln2.scale"]))


def _dec_layer(pr, w, pre, x, enc):
    x = x + _self_attn(pr, w, pre + "attn.", P.rmsnorm(x, w[pre + "ln1.scale"]),
                       causal=True)
    x = x + _cross_attn(pr, w, pre + "cross.",
                        P.rmsnorm(x, w[pre + "ln_x.scale"]), enc)
    return x + _ffn(pr, w, pre + "mlp.", P.rmsnorm(x, w[pre + "ln2.scale"]))


def _ce_chunk(pr, h, table, labels):
    tot, cnt = P.cross_entropy(pr.mm(h, table.T), labels)
    return tot, cnt.float()


def loss(c: dict, w: dict, batch: dict, pr=None, chunk: int = 512):
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``labels``
    (B, T), ``frames`` (B, S, d_model)) under the float32 weights ``w``."""
    pr = pr or P.Precision()
    w = dict(w, _H=c["num_heads"], _KV=c["num_kv_heads"], _hd=c["head_dim"])
    x = batch["frames"].float()
    for i in range(c["encoder_layers"]):
        x = checkpoint(_enc_layer, pr, w, f"encoder.stack.blocks.{i}.0.", x,
                       use_reentrant=False)
    enc = P.rmsnorm(x, w["encoder.final_norm.scale"])
    x = w["embed.table"][batch["tokens"]]
    for i in range(c["decoder_layers"]):
        x = checkpoint(_dec_layer, pr, w, f"stack.blocks.{i}.0.", x, enc,
                       use_reentrant=False)
    h = P.rmsnorm(x, w["final_norm.scale"]).reshape(-1, c["d_model"])
    labels = batch["labels"].reshape(-1).long()
    tot = cnt = 0.0
    for r0 in range(0, h.shape[0], chunk):
        t, n = checkpoint(_ce_chunk, pr, h[r0:r0 + chunk], w["embed.table"],
                          labels[r0:r0 + chunk], use_reentrant=False)
        tot, cnt = tot + t, cnt + n
    return tot / cnt


def dsgdm_steps(c: dict, x: dict, u: dict | None, batches, *, nodes: int,
                k: int, momentum: float, eta: float, steps: int, t0: int = 0,
                storage=torch.bfloat16, pr=None, on_step=None):
    """``steps`` rounds of DSGD-momentum, rounds ``t0`` to ``t0 + steps -
    1`` of the Base-(k+1) schedule, from the node-stacked parameters ``x``
    and momentum ``u`` (name -> (nodes, ...); ``u`` None starts at zero)
    over ``batches(t)``, a list of each node's batch at round t.

    The arithmetic is float32; what the configuration stores is rounded
    to ``storage`` where it is stored: the momentum after its update, the
    parameters after the local step (the payload the nodes exchange) and
    after the mix.  ``on_step(t, losses, x, u, gnorm)`` sees each round's
    per-node losses, the parameters and momentum after it, and each leaf's
    (nodes,) float32 gradient norms.  Returns ``(x, u)``; the tensors
    given are not modified."""
    names = sorted(x)
    dev = x[names[0]].device
    Ws = [W.to(dev, torch.float32) for W in P.base_matrices(nodes, k)]
    if u is None:
        u = {n: torch.zeros_like(x[n], dtype=storage) for n in names}
    for t in range(t0, t0 + steps):
        losses, gnorm = [], {n: [] for n in names}
        u_new = {n: torch.empty_like(u[n], dtype=storage) for n in names}
        half = {n: torch.empty_like(x[n], dtype=storage) for n in names}
        for i, b in enumerate(batches(t)):
            leaves = {n: x[n][i].to(torch.float32, copy=True)
                      .requires_grad_() for n in names}
            li = loss(c, leaves, b, pr)
            grads = torch.autograd.grad(li, [leaves[n] for n in names])
            losses.append(float(li.detach()))
            with torch.no_grad():
                for n, g in zip(names, grads):
                    gnorm[n].append(torch.linalg.vector_norm(g))
                    un = u[n][i].float().mul(momentum).add_(g)
                    u_new[n][i] = un
                    half[n][i] = leaves[n].detach().sub_(
                        u_new[n][i].float(), alpha=eta)
            del grads, leaves
        W = Ws[t % len(Ws)]
        with torch.no_grad():
            x = {n: torch.tensordot(W, half[n].float(), dims=([1], [0]))
                 .to(storage) for n in names}
        u = u_new
        del half
        if on_step is not None:
            on_step(t, losses, x, u,
                    {n: torch.stack(v).cpu() for n, v in gnorm.items()})
    return x, u
