"""qwen1.5-4b [dense, QKV bias]  (hf:Qwen/Qwen1.5-0.5B family card)
— the reference's ``repro/configs/qwen15_4b.py``.

40L, d_model=2560, 20 heads (kv=20 — MHA), d_ff=6912, vocab=151936,
attention QKV projections carry biases (Qwen1/1.5 signature).
"""
from .common import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    pattern=(LayerSpec(kind="attn", ffn="dense"),),
    num_blocks=40,
    qkv_bias=True,
    mlp_act="silu",
    tie_embeddings=True,
    source="hf:Qwen/Qwen1.5-0.5B",
)
