"""llava-next-34b [vlm, anyres tiling]
(hf:llava-hf/llava-v1.6-mistral-7b-hf family; 34B = Nous-Hermes-2-Yi-34B
backbone) — the reference's ``repro/configs/llava_next_34b.py``.

60L, d_model=7168, 56 heads GQA kv=8, d_ff=20480, vocab=64000.  The
SigLIP/CLIP vision tower + projector is stubbed: ``prefix_embeds``
supplies (B, 2880, d_model) anyres patch embeddings
(``models/frontends.py``).
"""
from .common import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    pattern=(LayerSpec(kind="attn", ffn="dense"),),
    num_blocks=60,
    frontend="vision",
    mlp_act="silu",
    tie_embeddings=False,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
