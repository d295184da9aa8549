"""Analytic matmul-level cost model for the roofline analysis (port of
``repro/analysis/flops.py``: the same terms, in the same order).

Why analytic: XLA's ``compiled.cost_analysis()`` counts ``while``-loop
bodies ONCE, not x trip-count (verified in EXPERIMENTS.md §Dry-run), so
the measured FLOPs/bytes for a scanned-stack model understate the real
work by ~the block count.  This module reproduces XLA's op-level counting
analytically with trip counts applied; setting ``trip_counts=False``
collapses every scan to one iteration, which must (and does) agree with
the measured numbers — that cross-check validates the model and is
reported per pair in §Roofline.

All numbers are GLOBAL; divide by chip count for per-device roofline
terms (the compute term's definition).  The roofline constants are the
H100's (``launch.mesh.PEAK_FLOPS_BF16``, ``HBM_BW``).

Here :func:`param_counts` counts the parameters of a
``models.model.Model`` on the meta device, in place of the reference's
``jax.eval_shape``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

from repro_torch.configs.common import ArchConfig, LayerSpec


@dataclass
class Cost:
    flops: float = 0.0
    notes: dict = field(default_factory=dict)

    def add(self, key: str, f: float):
        self.flops += f
        self.notes[key] = self.notes.get(key, 0.0) + f


def _attn_flops(cfg: ArchConfig, spec: LayerSpec, n_tok: float,
                s_eff: float) -> float:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.mla is not None:
        m = cfg.mla
        qk = m.qk_nope_dim + m.qk_rope_dim
        f = 2 * n_tok * D * m.q_lora_rank
        f += 2 * n_tok * m.q_lora_rank * H * qk
        f += 2 * n_tok * D * (m.kv_lora_rank + m.qk_rope_dim)
        f += 2 * n_tok * m.kv_lora_rank * H * (m.qk_nope_dim + m.v_head_dim)
        f += 2 * n_tok * s_eff * H * (qk + m.v_head_dim)
        f += 2 * n_tok * H * m.v_head_dim * D
        return f
    f = 2 * n_tok * D * (H + 2 * KV) * hd          # qkv proj
    f += 2 * n_tok * s_eff * H * hd * 2            # scores + weighted sum
    f += 2 * n_tok * H * hd * D                    # out proj
    return f


def _ffn_flops(cfg: ArchConfig, spec: LayerSpec, n_tok: float) -> float:
    if spec.ffn == "none":
        return 0.0
    if spec.ffn == "moe":
        mo = cfg.moe
        f = 2 * n_tok * cfg.d_model * mo.num_experts          # router
        f += 6 * n_tok * mo.top_k * mo.capacity_factor * \
            cfg.d_model * mo.d_expert                          # routed
        f += 6 * n_tok * cfg.d_model * mo.d_expert * mo.num_shared
        return f
    return 6 * n_tok * cfg.d_model * cfg.d_ff


def _mamba_flops(cfg: ArchConfig, n_tok: float, decode: bool) -> float:
    s = cfg.ssm
    D = cfg.d_model
    di = s.d_inner(D)
    h = s.nheads(D)
    n = s.d_state
    M = 2 * di + 2 * n + h
    f = 2 * n_tok * D * M                          # in_proj
    f += 2 * s.d_conv * n_tok * (di + 2 * n)       # depthwise conv
    if decode:
        f += 2 * 2 * n_tok * n * di                # state update + readout
    else:
        l = s.chunk
        f += 2 * n_tok * l * n                     # C B^T per chunk
        f += 2 * n_tok * l * di                    # intra-chunk apply
        f += 4 * n_tok * n * di                    # states + y_off
    f += 2 * n_tok * di * D                        # out_proj
    return f


def _cross_flops(cfg: ArchConfig, n_tok_dec: float, n_tok_enc: float
                 ) -> float:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    f = 2 * n_tok_dec * D * H * hd + 2 * n_tok_dec * H * hd * D
    f += 2 * n_tok_enc * D * 2 * KV * hd           # K/V recomputed from enc
    f += 2 * n_tok_dec * n_tok_enc / max(n_tok_dec, 1) * 0  # placeholder
    return f


def _layers(cfg: ArchConfig, trip_counts: bool):
    """(spec, multiplicity) honouring trip_counts semantics."""
    out = [(s, 1.0) for s in cfg.prologue]
    mult = cfg.num_blocks if trip_counts else 1.0
    out += [(s, mult) for s in cfg.pattern]
    return out


def forward_flops(cfg: ArchConfig, *, batch: float, T: float,
                  S: float | None = None, decode: bool = False,
                  trip_counts: bool = True, enc_T: float = 0.0) -> Cost:
    """One forward pass.  T = new tokens per sequence; S = kv length
    (defaults to T, causal-halved for self-attention)."""
    c = Cost()
    n_tok = batch * T
    for spec, mult in _layers(cfg, trip_counts):
        if spec.kind == "mamba":
            c.add("mamba", mult * _mamba_flops(cfg, n_tok, decode))
        else:
            if decode:
                s_eff = min(spec.window or S, S)
            elif S is not None and S != T:
                s_eff = min(spec.window or S, S)
            else:
                s_eff = min(spec.window or T, (T + 1) / 2
                            if spec.window is None else spec.window)
            c.add("attn", mult * _attn_flops(cfg, spec, n_tok, s_eff))
        if spec.cross_attn:
            D, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
            f = 2 * n_tok * D * H * hd + 2 * n_tok * H * hd * D
            f += 2 * batch * enc_T * D * 2 * cfg.num_kv_heads * hd
            f += 2 * n_tok * enc_T * H * hd * 2
            c.add("cross", mult * f)
        c.add("ffn", mult * _ffn_flops(cfg, spec, n_tok))
    # encoder
    if cfg.encoder is not None and enc_T:
        enc_tok = batch * enc_T
        spec = LayerSpec(kind="attn", ffn="dense")
        per = _attn_flops(cfg, spec, enc_tok, (enc_T + 1) / 2) \
            + 6 * enc_tok * cfg.d_model * cfg.encoder.d_ff
        c.add("encoder",
              per * (cfg.encoder.num_layers if trip_counts else 1))
    # lm head
    c.add("head", 2 * n_tok * cfg.d_model * cfg.vocab_size)
    if cfg.mtp:
        spec = LayerSpec(kind="attn", ffn="dense")
        c.add("mtp", _attn_flops(cfg, spec, n_tok, (T + 1) / 2)
              + 6 * n_tok * cfg.d_model * cfg.d_ff
              + 2 * n_tok * cfg.d_model * cfg.vocab_size)
    return c


def train_flops(cfg: ArchConfig, *, global_batch: int, seq: int,
                remat: bool = True, trip_counts: bool = True,
                enc_T: float = 0.0, text_T: float | None = None) -> Cost:
    """fwd + bwd(2x) + remat recompute of scanned blocks (1x fwd)."""
    T = text_T if text_T is not None else seq
    fwd = forward_flops(cfg, batch=global_batch, T=T, trip_counts=trip_counts,
                        enc_T=enc_T)
    c = Cost()
    for k, v in fwd.notes.items():
        factor = 3.0
        if remat and k in ("attn", "ffn", "mamba", "cross", "encoder"):
            factor = 4.0
        c.add(k, v * factor)
    return c


# ---------------------------------------------------------------------------
# parameter counts (MODEL_FLOPS = 6 N D uses these)
# ---------------------------------------------------------------------------

@functools.cache
def _total_params(cfg: ArchConfig) -> int:
    from repro_torch.models import model as M
    return sum(t.numel() for t in M.param_specs(cfg).values())


def param_counts(cfg: ArchConfig) -> dict:
    """Total & active parameter counts (active: top-k routed experts)."""
    total = _total_params(cfg)
    embed = cfg.vocab_size * cfg.d_model
    if not cfg.tie_embeddings:
        embed *= 2
    active = total
    if cfg.moe is not None:
        mo = cfg.moe
        n_moe_layers = sum(
            (1 if s.ffn == "moe" else 0) for s in cfg.prologue) + \
            cfg.num_blocks * sum(1 if s.ffn == "moe" else 0
                                 for s in cfg.pattern)
        per_expert = 3 * cfg.d_model * mo.d_expert
        active -= n_moe_layers * (mo.num_experts - mo.top_k) * per_expert
    return {"total": total, "active": active, "embed": embed,
            "nonembed_active": active - embed}


def model_flops(cfg: ArchConfig, *, kind: str, global_batch: int,
                seq: int, text_T: float | None = None) -> float:
    """The 6*N*D (train) / 2*N*D (inference) convention, N = active
    non-embedding params, D = tokens processed."""
    n = param_counts(cfg)["nonembed_active"]
    T = text_T if text_T is not None else seq
    tokens = global_batch * (T if kind != "decode" else 1)
    return (6 if kind == "train" else 2) * n * tokens
