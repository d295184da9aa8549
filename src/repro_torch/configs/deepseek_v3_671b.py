"""deepseek-v3-671b [moe, MLA, MTP]  (arXiv:2412.19437) — the reference's
``repro/configs/deepseek_v3_671b.py``.

61L, d_model=7168, 128 heads with Multi-head Latent Attention
(q_lora=1536, kv_lora=512, nope=128, rope=64, v=128), vocab=129280.
First 3 layers dense (d_ff=18432); remaining 58 layers MoE with 1 shared
+ 256 routed experts, top-8, expert d_ff=2048.  One MTP head.
"""
from .common import ArchConfig, LayerSpec, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,      # MLA: kv latent shared; head count for Q/K expand
    head_dim=128,
    d_ff=18432,            # dense (prologue) layers
    vocab_size=129280,
    prologue=tuple(LayerSpec(kind="attn", ffn="dense") for _ in range(3)),
    pattern=(LayerSpec(kind="attn", ffn="moe"),),
    num_blocks=58,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048, num_shared=1,
                  capacity_factor=1.25),
    mtp=1,
    mlp_act="silu",
    tie_embeddings=False,
    source="arXiv:2412.19437",
)
