"""Small configurations and traffic for the benchmark's CPU tests: the
cells' own files with every width cut, so that a run on the CPU's plain
kernels takes seconds."""
from __future__ import annotations

from perfbench import lib

SEAMLESS = {
    "name": "seamless-m4t-large-v2", "arch": "seamless-m4t-large-v2",
    "d_model": 64, "num_heads": 4, "num_kv_heads": 4, "head_dim": 16,
    "d_ff": 128, "vocab_size": 512, "decoder_layers": 2,
    "encoder_layers": 2, "encoder_d_ff": 96, "mlp_act": "gelu",
    "tie_embeddings": True,
    "reduced": ["d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
                "vocab_size", "decoder_layers", "encoder_layers",
                "encoder_d_ff"]}

GROK = {
    "name": "grok-1-314b", "arch": "grok-1-314b", "d_model": 1024,
    "num_heads": 4, "num_kv_heads": 2, "head_dim": 16, "vocab_size": 512,
    "num_hidden_layers": 2, "num_experts": 4, "top_k": 2, "d_expert": 96,
    "capacity_factor": 1.25, "attn_softcap": 30.0, "final_softcap": 30.0,
    "mlp_act": "gelu", "tie_embeddings": True,
    "reduced": ["d_model", "num_heads", "num_kv_heads", "head_dim",
                "vocab_size", "num_hidden_layers", "num_experts",
                "d_expert"]}


def train_traffic(cell: str = "encdec-dsgd") -> dict:
    t = lib.load_json("traffic", f"{cell}.json")
    t.update(seqs_per_node=2, seq_len=16, frames=16)
    return t


def serve_traffic(cell: str = "grok-chat") -> dict:
    t = lib.load_json("traffic", f"{cell}.json")
    t.update(slots=8, page_size=4, buckets=[8, 16], max_new=8,
             rate_per_step=1.0, kept_steps=4,
             prompt={"dist": "lognormal", "median": 8, "sigma": 0.5,
                     "min": 4, "max": 16})
    return t
