"""The assigned input shapes and their meta-device tensors for the dry
run (port of ``repro/launch/shapes.py``).

Shapes (assignment):
    train_4k       seq=  4,096  global_batch=256   (train_step)
    prefill_32k    seq= 32,768  global_batch= 32   (prefill)
    decode_32k     seq= 32,768  global_batch=128   (serve_step, 1 token)
    long_500k      seq=524,288  global_batch=  1   (serve_step, 1 token,
                                                    sub-quadratic archs only)

For [vlm]/[audio] archs the modality budget comes out of / adds to the
token stream as documented in DESIGN.md: vlm text tokens = seq - patches;
audio adds a (B, 1024, d_model) source-frame tensor.

The reference's ``ShapeDtypeStruct`` is a tensor on the ``meta`` device
here: it has a shape and a dtype and no storage.
"""
from __future__ import annotations

import torch

from repro_torch.configs.common import ArchConfig
from repro_torch.models.frontends import AUDIO_FRAMES, VISION_PATCHES

INPUT_SHAPES = {
    "train_4k": dict(seq=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq=524288, global_batch=1, kind="decode"),
}

SHAPE_NAMES = tuple(INPUT_SHAPES)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def text_len(cfg: ArchConfig, seq: int) -> int:
    if cfg.frontend == "vision":
        return seq - VISION_PATCHES
    return seq


def train_batch_shapes(cfg: ArchConfig, n_nodes: int, *, seq: int,
                       global_batch: int, dtype=torch.bfloat16) -> dict:
    assert global_batch % max(n_nodes, 1) == 0
    b = global_batch // max(n_nodes, 1)
    t = text_len(cfg, seq)
    out = {
        "tokens": _meta((n_nodes, b, t), torch.int32),
        "labels": _meta((n_nodes, b, t), torch.int32),
    }
    if cfg.frontend == "audio":
        out["frames"] = _meta((n_nodes, b, AUDIO_FRAMES, cfg.d_model), dtype)
    elif cfg.frontend == "vision":
        out["prefix_embeds"] = _meta((n_nodes, b, VISION_PATCHES,
                                      cfg.d_model), dtype)
    return out


def prefill_batch_shapes(cfg: ArchConfig, *, batch: int, seq: int,
                         dtype=torch.bfloat16) -> dict:
    t = text_len(cfg, seq)
    out = {"tokens": _meta((batch, t), torch.int32)}
    if cfg.frontend == "audio":
        out["frames"] = _meta((batch, AUDIO_FRAMES, cfg.d_model), dtype)
    elif cfg.frontend == "vision":
        out["prefix_embeds"] = _meta((batch, VISION_PATCHES, cfg.d_model),
                                     dtype)
    return out


def decode_inputs(cfg: ArchConfig, *, batch: int, seq: int,
                  cache_dtype=torch.bfloat16):
    """(cache, tokens, index, enc_out|None) on the meta device; the cache
    is the port's ``init_cache`` there."""
    from repro_torch.models import model as M
    cache = M.init_cache(cfg, batch, seq, cache_dtype, device="meta")
    tokens = _meta((batch, 1), torch.int32)
    index = _meta((), torch.int32)
    enc = None
    if cfg.encoder is not None:
        enc = _meta((batch, AUDIO_FRAMES, cfg.d_model), cache_dtype)
    return cache, tokens, index, enc


def skip_reason(cfg: ArchConfig, shape_name: str) -> str | None:
    """Documented skips (DESIGN.md Sec. 4)."""
    if shape_name == "long_500k" and cfg.long_context_variant() is None:
        return ("full-attention architecture without a sub-quadratic "
                "variant: long_500k skipped per assignment rules")
    return None


def config_for_shape(cfg: ArchConfig, shape_name: str) -> ArchConfig:
    """long_500k swaps in the sub-quadratic variant (window-clamped
    globals for gemma2/3; identity for SSM/hybrid)."""
    if shape_name == "long_500k":
        v = cfg.long_context_variant()
        assert v is not None, f"{cfg.name} skips long_500k"
        return v
    return cfg
