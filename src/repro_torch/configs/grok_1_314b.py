"""grok-1-314b [moe]  (hf:xai-org/grok-1) — the reference's
``repro/configs/grok_1_314b.py``.

64L, d_model=6144, 48 heads GQA kv=8, vocab=131072, 8 experts top-2 with
expert d_ff=32768, attention/output logit softcaps (30) per the released
implementation.
"""
from .common import ArchConfig, LayerSpec, MoEConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    pattern=(LayerSpec(kind="attn", ffn="moe"),),
    num_blocks=64,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=32768,
                  capacity_factor=1.25),
    attn_softcap=30.0,
    final_softcap=30.0,
    mlp_act="gelu",
    tie_embeddings=True,
    source="hf:xai-org/grok-1",
)
