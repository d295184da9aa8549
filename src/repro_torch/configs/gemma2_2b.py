"""gemma2-2b [dense, local+global alternating, logit softcap]
(arXiv:2408.00118) — the reference's ``repro/configs/gemma2_2b.py``.

26L, d_model=2304, 8 heads GQA kv=4, head_dim=256, d_ff=9216 (GeGLU),
vocab=256000.  Alternating sliding-window(4096)/global attention,
attention-logit softcap 50, final-logit softcap 30, sandwich (post)
norms, sqrt(d_model) embedding scaling.
"""
from .common import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    pattern=(LayerSpec(kind="attn", ffn="dense", window=4096),
             LayerSpec(kind="attn", ffn="dense", window=None)),
    num_blocks=13,
    attn_softcap=50.0,
    final_softcap=30.0,
    mlp_act="gelu",
    embed_scale=True,
    post_norm=True,
    tie_embeddings=True,
    source="arXiv:2408.00118",
)
