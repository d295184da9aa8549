"""jamba-1.5-large-398b [hybrid: Mamba + attention 1:7, MoE]
(arXiv:2403.19887) — the reference's
``repro/configs/jamba_15_large_398b.py``.

72L, d_model=8192, 64 heads GQA kv=8, d_ff=24576, vocab=65536.
Period-8 blocks: attention at in-block index 4, Mamba elsewhere (1:7);
MoE (16 experts, top-2) on every other layer, dense FFN otherwise.
"""
from .common import ArchConfig, LayerSpec, MoEConfig, SSMConfig


def _spec(i: int) -> LayerSpec:
    kind = "attn" if i == 4 else "mamba"
    ffn = "moe" if i % 2 == 1 else "dense"
    return LayerSpec(kind=kind, ffn=ffn)


CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    pattern=tuple(_spec(i) for i in range(8)),
    num_blocks=9,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, headdim=64, chunk=128),
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=24576,
                  capacity_factor=1.25),
    mlp_act="silu",
    tie_embeddings=True,
    source="arXiv:2403.19887",
)
