"""gemma3-1b [dense, 5:1 local:global, 128k context]
(hf:google/gemma-3-1b-pt) — the reference's ``repro/configs/gemma3_1b.py``.

26L, d_model=1152, 4 heads GQA kv=1 (MQA), head_dim=256, d_ff=6912,
vocab=262144.  5 sliding-window(512) layers per 1 global layer; QK-norm;
RoPE theta 10k local / 1M global; sandwich norms; embeddings scaled.

Layer layout (prologue=2 locals, 4 x [5 local + 1 global]) is the
reference's: globals at layers 8,14,20,26, which keeps the released
checkpoint's 5:1 ratio (DESIGN.md).
"""
from .common import ArchConfig, LayerSpec

_LOCAL = LayerSpec(kind="attn", ffn="dense", window=512, rope_theta=10_000.0)
_GLOBAL = LayerSpec(kind="attn", ffn="dense", window=None,
                    rope_theta=1_000_000.0)

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    prologue=(_LOCAL, _LOCAL),
    pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    num_blocks=4,
    qk_norm=True,
    mlp_act="gelu",
    embed_scale=True,
    post_norm=True,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)
