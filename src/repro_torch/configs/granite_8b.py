"""granite-8b [dense, llama-arch, code]  (arXiv:2405.04324) — the
reference's ``repro/configs/granite_8b.py``.

36L, d_model=4096, 32 heads GQA kv=8, d_ff=14336 (SwiGLU), vocab=49152.
"""
from .common import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    pattern=(LayerSpec(kind="attn", ffn="dense"),),
    num_blocks=36,
    mlp_act="silu",
    tie_embeddings=True,           # granite-code ties embeddings
    source="arXiv:2405.04324",
)
