"""mamba2-2.7b [ssm, attention-free, SSD]  (arXiv:2405.21060) — the
reference's ``repro/configs/mamba2_27b.py``.

64L, d_model=2560, ssm_state=128, expand=2 (d_inner=5120), headdim=64
(80 SSD heads), vocab=50280.  No attention, no FFN (the Mamba block IS the
mixer+channel mix).
"""
from .common import ArchConfig, LayerSpec, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    d_model=2560,
    num_heads=1,          # unused (attention-free)
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    pattern=(LayerSpec(kind="mamba", ffn="none"),),
    num_blocks=64,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, headdim=64, chunk=128),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
