"""Architecture config schema (port of ``repro/configs/common.py``).

The JAX schema imports ``MoEConfig`` and ``SSMConfig`` from the model
modules, which import JAX, so the port keeps its own copy of the whole
schema and holds both sub-configs here as plain dataclasses.  Field
names, defaults and ``reduced()`` are the reference's, so a config built
here and one built there describe the same model.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int               # expert FFN hidden size
    num_shared: int = 0         # shared (always-on) experts
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    aux_loss_coef: float = 0.001
    normalize_gates: bool = True


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    chunk: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def nheads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class LayerSpec:
    kind: str = "attn"            # "attn" | "mamba"
    ffn: str = "dense"            # "dense" | "moe" | "none"
    window: int | None = None     # sliding-window width (attn only)
    rope_theta: float = 10000.0
    cross_attn: bool = False      # enc-dec decoder layers


@dataclass(frozen=True)
class EncoderConfig:
    """Transformer encoder consuming stub-frontend embeddings."""
    num_layers: int
    d_ff: int


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    pattern: tuple[LayerSpec, ...]
    num_blocks: int
    prologue: tuple[LayerSpec, ...] = ()
    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: float | None = None
    final_softcap: float | None = None
    attn_scale: float | None = None
    mlp_act: str = "silu"
    # family sub-configs
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    encoder: EncoderConfig | None = None
    frontend: str | None = None   # "audio" | "vision" (stub embeddings)
    mtp: int = 0                  # deepseek multi-token-prediction depth
    # embedding / output
    tie_embeddings: bool = True
    embed_scale: bool = False     # gemma: embeddings * sqrt(d_model)
    post_norm: bool = False       # gemma2/3 sandwich norms
    # citation for the exact numbers above
    source: str = ""

    @property
    def num_layers(self) -> int:
        return len(self.prologue) + self.num_blocks * len(self.pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if every layer's attention cost is O(T * window) or O(T)
        (SSM) — i.e. the arch may run the long_500k shape."""
        specs = list(self.prologue) + list(self.pattern)
        return all(s.kind == "mamba" or s.window is not None for s in specs)

    def long_context_variant(self, clamp: int = 32768) -> "ArchConfig | None":
        """Config eligible for long_500k (assignment rules):
          * SSM/hybrid: run as-is (O(1)/O(L) decode state).
          * dense archs with native sliding-window layers (gemma2/gemma3):
            the minority global layers are clamped to a ``clamp``-wide
            window — the documented sub-quadratic variant (DESIGN.md).
          * pure full-attention archs: None (skip)."""
        if self.family in ("ssm", "hybrid"):
            return self
        specs = list(self.prologue) + list(self.pattern)
        if not any(s.window is not None for s in specs if s.kind == "attn"):
            return None

        def cl(s: LayerSpec) -> LayerSpec:
            if s.kind == "attn" and s.window is None:
                return replace(s, window=clamp)
            return s
        return replace(self,
                       prologue=tuple(cl(s) for s in self.prologue),
                       pattern=tuple(cl(s) for s in self.pattern))

    def reduced(self, *, num_blocks: int | None = None) -> "ArchConfig":
        """Smoke-test variant: same family/pattern, tiny dims
        (<= 2 pattern blocks, d_model <= 512, <= 4 experts)."""
        d = min(self.d_model, 256)
        hd = 64
        heads = max(2, min(4, self.num_heads))
        kv = 1 if self.num_kv_heads == 1 else 2
        moe = None
        if self.moe is not None:
            moe = replace(self.moe, num_experts=4, top_k=2, d_expert=128,
                          num_shared=min(self.moe.num_shared, 1))
        mla = None
        if self.mla is not None:
            mla = MLAConfig(q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=32,
                            qk_rope_dim=16, v_head_dim=32)
        ssm = None
        if self.ssm is not None:
            ssm = replace(self.ssm, d_state=16, headdim=32, chunk=8)
        enc = None
        if self.encoder is not None:
            enc = EncoderConfig(num_layers=2, d_ff=256)
        # shrink windows so tiny sequences still exercise the masking
        pat = tuple(replace(s, window=(4 if s.window else None))
                    for s in self.pattern)
        pro = tuple(replace(s, window=(4 if s.window else None))
                    for s in self.prologue)
        return replace(
            self, d_model=d, num_heads=heads, num_kv_heads=kv, head_dim=hd,
            d_ff=min(self.d_ff, 256) or 0, vocab_size=512,
            pattern=pat, prologue=pro[:1],
            num_blocks=num_blocks if num_blocks is not None
            else max(1, min(2, 8 // max(1, len(self.pattern)))),
            moe=moe, mla=mla, ssm=ssm, encoder=enc)
