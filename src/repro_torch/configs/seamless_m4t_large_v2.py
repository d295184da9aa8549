"""seamless-m4t-large-v2 [audio, enc-dec]  (arXiv:2308.11596) — the
reference's ``repro/configs/seamless_m4t_large_v2.py``.

24L encoder + 24L decoder transformer backbone, d_model=1024, 16 heads
(GQA kv=16 — full MHA), d_ff=8192, vocab=256206.  The speech frontend
(mel + conformer feature extractor) is stubbed: ``frames`` inputs are
precomputed (B, 1024, d_model) embeddings (``models/frontends.py``).
"""
from .common import ArchConfig, EncoderConfig, LayerSpec

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    pattern=(LayerSpec(kind="attn", ffn="dense", cross_attn=True),),
    num_blocks=24,
    encoder=EncoderConfig(num_layers=24, d_ff=8192),
    frontend="audio",
    mlp_act="gelu",
    tie_embeddings=True,
    source="arXiv:2308.11596",
)
