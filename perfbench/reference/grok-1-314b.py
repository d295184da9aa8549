"""Plain float32 reference of grok-1-314b (hf:xai-org/grok-1) as the
benchmark serves it: a decoder of pre-norm layers, each grouped-query
attention with rotary positions and softcapped scores, then a mixture of
experts with capacity routing; the tied, softcapped output projection.

Layer equations (every norm ``x / rms(x) * (1 + scale)``, eps 1e-6):

    x += Wo attn(rope(Wq n1(x)), rope(Wk n1(x)), Wv n1(x))
         scores s = q.k / sqrt(hd), capped 30 tanh(s / 30), causal
    x += moe(n2(x))
    logits = 30 tanh((n_f(x) @ E^T) / 30)

The mixture of experts over the N tokens of one call: router softmax
p = softmax(x @ R) in float32; each token picks its top-2 experts (the
lower index first among equal values) with gates p normalised over the
two; each expert keeps the C = min(N, max(1, floor(N * 2 * 1.25 / 8)))
tokens of highest gate among those that picked it (ties again by lower
index) and drops the rest; a kept token gets gate * W_down(gelu(W_gate
x) * W_up x) from each of its experts.  The routing and the capacity
depend on every token of the call, so the reference takes a call's
tokens as the port's call has them: a prompt right-padded with token 0
to its bucket; a decode step's every slot, a free slot decoding token 0
at position 0 over that one position.

Weights arrive as the bfloat16 tensors the benchmark drew, keyed by the
port's parameter names; each is widened to float32 where it is used, one
expert at a time, so the 41 GB of weights are not held twice.  Nothing
of the port is imported.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

_spec = importlib.util.spec_from_file_location(
    "perfbench_reference_plain", Path(__file__).with_name("_plain.py"))
P = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(P)


def _f(w, name):
    return w[name].float()


def moe(c: dict, pr, w: dict, pre: str, x):
    """x (N, D) -> (N, D) through the layer's experts, capacity-routed."""
    N = x.shape[0]
    E, K = c["num_experts"], c["top_k"]
    probs = torch.softmax(x @ _f(w, pre + "router"), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, chosen = vals[:, :K], idx[:, :K]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    sel = torch.zeros(N, E, device=x.device).scatter(1, chosen, gate)
    cap = min(N, max(1, int(N * K * c["capacity_factor"] / E)))
    score, tok = torch.sort(sel.T, dim=-1, descending=True, stable=True)
    score, tok = score[:, :cap], tok[:, :cap]
    y = torch.zeros_like(x)
    for e in range(E):
        keep = score[e] > 0
        if not bool(keep.any()):
            continue
        t = tok[e][keep]
        h = P.gated_ffn(pr, x[t], w[pre + "w_gate"][e].float(),
                        w[pre + "w_up"][e].float(),
                        w[pre + "w_down"][e].float())
        y.index_add_(0, t, h * score[e][keep][:, None])
    return y


def _qkv(c, pr, w, pre, h, pos):
    H, KV, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    T = h.shape[0]
    q = P.rope(pr.mm(h, _f(w, pre + "wq.w")).reshape(T, H, hd), pos)
    k = P.rope(pr.mm(h, _f(w, pre + "wk.w")).reshape(T, KV, hd), pos)
    v = pr.mm(h, _f(w, pre + "wv.w")).reshape(T, KV, hd)
    return q, k, v


def _head(c, pr, w, x):
    cap = c["final_softcap"]
    z = pr.mm(P.rmsnorm(x, w["final_norm.scale"]), _f(w, "embed.table").T)
    return cap * torch.tanh(z / cap)


def prefill(c: dict, w: dict, tokens, prompt_len: int, pr=None):
    """One prompt right-padded to its bucket (``tokens`` (bucket,)):
    the logits at its last real row (V,), and each layer's keys and
    values at its real rows, [(k, v) (prompt_len, KV, hd)]."""
    pr = pr or P.Precision()
    T = tokens.shape[0]
    pos = torch.arange(T, device=tokens.device)
    mask = P.causal_mask(T, T, tokens.device)
    x = _f(w, "embed.table")[tokens]
    kv = []
    for i in range(c["num_hidden_layers"]):
        pre = f"stack.blocks.{i}.0."
        q, k, v = _qkv(c, pr, w, pre + "attn.", P.rmsnorm(x, w[pre + "ln1.scale"]),
                       pos)
        kv.append((k[:prompt_len], v[:prompt_len]))
        a = P.attend(pr, q, k, v, mask, c["attn_softcap"])
        x = x + pr.mm(a.reshape(T, -1), _f(w, pre + "attn.wo.w"))
        x = x + moe(c, pr, w, pre + "moe.", P.rmsnorm(x, w[pre + "ln2.scale"]))
    return _head(c, pr, w, x[prompt_len - 1:prompt_len])[0], kv


def first_layer_kv(c: dict, w: dict, tokens, pos, pr=None):
    """The first layer's keys and values [(T, KV, hd)] of ``tokens`` (T,)
    at positions ``pos`` (T,): what a cache holds there whatever else the
    call held, since no routing comes before them."""
    pr = pr or P.Precision()
    pre = "stack.blocks.0.0."
    x = w["embed.table"][tokens].float()
    h = P.rmsnorm(x, w[pre + "ln1.scale"])
    _, k, v = _qkv(c, pr, w, pre + "attn.", h, pos)
    return k, v


def decode(c: dict, w: dict, snap: dict, pr=None):
    """One lockstep decode step over every slot, from the cache the step
    found (``snap``: ``tok``, ``pos`` (B,), ``table`` (B, pages), ``active``
    (B,) bool, ``pools`` [(k, v) (pages, page, KV, hd)] per layer as the
    step found them, ``rows`` [(k, v) (B, KV, hd)] per layer as the step
    left the rows it wrote).  An active slot attends over its cached
    positions [0, pos) and its own fresh row; a free slot over the one row
    it wrote, which free slots share (the rows it left).  Returns the
    logits (B, V) and each layer's fresh rows [(k, v) (B, KV, hd)]."""
    pr = pr or P.Precision()
    tok, pos, table, active = snap["tok"], snap["pos"], snap["table"], \
        snap["active"]
    B = tok.shape[0]
    x = _f(w, "embed.table")[tok]
    fresh = []
    for i in range(c["num_hidden_layers"]):
        pre = f"stack.blocks.{i}.0."
        q, k, v = _qkv(c, pr, w, pre + "attn.",
                       P.rmsnorm(x, w[pre + "ln1.scale"]), pos)
        pk, pv = snap["pools"][i]
        rk, rv = snap["rows"][i]
        fresh.append((k, v))
        ps = pk.shape[1]
        outs = []
        for b in range(B):
            n = int(pos[b])
            rows = torch.arange(n, device=tok.device)
            page = table[b].long()[rows // ps]
            own_k = k[b] if bool(active[b]) else rk[b].float()
            own_v = v[b] if bool(active[b]) else rv[b].float()
            kk = torch.cat([pk[page, rows % ps].float(), own_k[None]])
            vv = torch.cat([pv[page, rows % ps].float(), own_v[None]])
            mask = torch.ones(1, n + 1, dtype=torch.bool, device=tok.device)
            outs.append(P.attend(pr, q[b][None], kk, vv, mask,
                                 c["attn_softcap"]).reshape(-1))
        x = x + pr.mm(torch.stack(outs), _f(w, pre + "attn.wo.w"))
        x = x + moe(c, pr, w, pre + "moe.", P.rmsnorm(x, w[pre + "ln2.scale"]))
    return _head(c, pr, w, x), fresh
