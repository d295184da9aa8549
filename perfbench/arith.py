"""The yardstick's arithmetic: the useful operations of a training step
and of served tokens, and each kernel's operations and bytes from its
shapes.  A frozen copy of the counting in the port's
``repro_torch/analysis/flops.py`` (the terms for attention, gated feed-
forward layers, routed experts, the encoder, cross-attention and the tied
head), corrected where the copy had it wrong for this use: a non-causal
attention (the encoder, cross-attention) counts its whole score matrix,
and routed experts count the top-k tokens a token is sent to, not the
capacity's slots.  Sizes come from a configuration file of
``perfbench/configs``; nothing here reads the port.

A multiply-add counts 2 operations.  Bytes count each input read once and
each output written once.
"""
from __future__ import annotations


def _attn_proj(c: dict, n: float) -> float:
    """q, k, v and output projections of ``n`` tokens."""
    D, H, KV, hd = c["d_model"], c["num_heads"], c["num_kv_heads"], c["head_dim"]
    return 2 * n * D * (2 * H + 2 * KV) * hd


def attn_scores(H: int, hd: int, tq: int, s: int, causal: bool) -> float:
    """QK^T and PV of one sequence: causal counts the score matrix's
    lower triangle, diagonal included, of a square block."""
    pairs = tq * (tq + 1) / 2 if causal and tq == s else tq * s
    return 4 * H * hd * pairs


def _ffn(c: dict, n: float, d_ff: int) -> float:
    return 6 * n * c["d_model"] * d_ff


def _moe(c: dict, n: float) -> float:
    return (2 * n * c["d_model"] * c["num_experts"]
            + 6 * n * c["top_k"] * c["d_model"] * c["d_expert"])


def _layer_ffn(c: dict, n: float) -> float:
    return _moe(c, n) if c.get("num_experts") else _ffn(c, n, c["d_ff"])


def encdec_forward(c: dict, *, batch: int, seq: int, frames: int) -> float:
    """One forward of an encoder-decoder over ``batch`` sequences of
    ``seq`` target tokens and ``frames`` source frames, with the head over
    every target position."""
    H, hd = c["num_heads"], c["head_dim"]
    n_dec, n_enc = batch * seq, batch * frames
    enc = (_attn_proj(c, n_enc) + batch * attn_scores(H, hd, frames, frames, False)
           + _ffn(c, n_enc, c["encoder_d_ff"]))
    D, KV = c["d_model"], c["num_kv_heads"]
    cross = (2 * n_dec * D * H * hd * 2 + 2 * n_enc * D * 2 * KV * hd
             + batch * attn_scores(H, hd, seq, frames, False))
    dec = (_attn_proj(c, n_dec) + batch * attn_scores(H, hd, seq, seq, True)
           + cross + _ffn(c, n_dec, c["d_ff"]))
    head = 2 * n_dec * D * c["vocab_size"]
    return c["encoder_layers"] * enc + c["decoder_layers"] * dec + head


def train_step_flops(c: dict, *, nodes: int, batch: int, seq: int,
                     frames: int) -> float:
    """A training step of every node: forward + backward (twice the
    forward), no recomputation."""
    return 3 * nodes * encdec_forward(c, batch=batch, seq=seq, frames=frames)


def decoder_token_flops(c: dict, context: int) -> float:
    """One token of a decoder-only model through every layer, attending
    over ``context`` positions (itself included), and the head."""
    H, hd = c["num_heads"], c["head_dim"]
    per_layer = _attn_proj(c, 1) + attn_scores(H, hd, 1, context, False) \
        + _layer_ffn(c, 1)
    return c["num_hidden_layers"] * per_layer \
        + 2 * c["d_model"] * c["vocab_size"]


def prefill_flops(c: dict, prompt: int) -> float:
    """A prompt of ``prompt`` tokens (the real ones, not the bucket's
    padding) through every layer, causal, and the head at its last row."""
    H, hd = c["num_heads"], c["head_dim"]
    per_layer = _attn_proj(c, prompt) \
        + attn_scores(H, hd, prompt, prompt, True) + _layer_ffn(c, prompt)
    return c["num_hidden_layers"] * per_layer \
        + 2 * c["d_model"] * c["vocab_size"]


# ---------------------------------------------------------------------------
# kernels: (operations, bytes) of one launch
# ---------------------------------------------------------------------------

def flash_work(*, batch: int, heads: int, kv_heads: int, hd: int, tq: int,
               s: int, causal: bool, itemsize: int = 2):
    """The flash attention forward over ``batch`` sequences: q, k, v read,
    the output written."""
    ops = batch * attn_scores(heads, hd, tq, s, causal)
    nbytes = itemsize * batch * hd * (2 * tq * heads + 2 * s * kv_heads)
    return ops, nbytes


def paged_decode_work(*, lengths, heads: int, kv_heads: int, hd: int,
                      itemsize: int = 2):
    """One paged decode launch over slots attending over ``lengths``
    valid positions each: the valid K/V rows and the queries read, the
    outputs written."""
    total = sum(lengths)
    ops = 4 * heads * hd * total
    nbytes = itemsize * hd * (2 * kv_heads * total + 2 * heads * len(lengths))
    return ops, nbytes


def fused_dsgd_work(leaves):
    """The fused update over ``(numel, x itemsize, u itemsize, g itemsize)``
    leaves: x, u and g read, x and u written (2 operations an element for
    each of the momentum and the step)."""
    ops = sum(4 * n for n, *_ in leaves)
    nbytes = sum(n * (2 * xs + 2 * us + gs) for n, xs, us, gs in leaves)
    return ops, nbytes

