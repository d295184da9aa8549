"""Stub modality frontends (port of ``repro/models/frontends.py``).

The [audio] and [vlm] architectures specify the transformer backbone
only; the mel-spectrogram + conv feature extractor (audio) and the
ViT/SigLIP vision tower + projector (VLM) are stubs in the reference, and
here: they produce embeddings with the shapes the real frontends emit.
The draws come from an explicit ``torch.Generator`` and differ from the
reference's ``jax.random`` ones; parity tests take the reference's
embeddings as numpy arrays.
"""
from __future__ import annotations

import torch

# seamless-m4t: ~50 Hz frame rate after the conformer feature extractor;
# a fixed source-frame budget per utterance
AUDIO_FRAMES = 1024

# llava-next anyres: base 576 patches (24x24 @ 336px) + up to 4 tiles
# -> the common 5-tile budget of 2880 patches
VISION_PATCHES = 2880


def audio_frames_shape(batch: int, d_model: int,
                       frames: int = AUDIO_FRAMES) -> tuple[int, ...]:
    return (batch, frames, d_model)


def vision_patches_shape(batch: int, d_model: int,
                         patches: int = VISION_PATCHES) -> tuple[int, ...]:
    return (batch, patches, d_model)


def _stub(shape, generator, dtype, device):
    """N(0, 1) x 0.02 drawn in f32, cast to ``dtype``, then scaled in it,
    as the reference's ``normal(...).astype(dtype) * 0.02``."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.to(dtype) * 0.02


def stub_audio_frontend(generator: torch.Generator, batch: int,
                        d_model: int, dtype=torch.bfloat16, *, device,
                        frames: int = AUDIO_FRAMES) -> torch.Tensor:
    """Placeholder for the mel + conv encoder output: (batch, frames,
    d_model) on ``device`` (the generator's)."""
    return _stub(audio_frames_shape(batch, d_model, frames), generator,
                 dtype, device)


def stub_vision_frontend(generator: torch.Generator, batch: int,
                         d_model: int, dtype=torch.bfloat16, *, device,
                         patches: int = VISION_PATCHES) -> torch.Tensor:
    """Placeholder for the ViT tower + 2-layer MLP projector output:
    (batch, patches, d_model) on ``device`` (the generator's)."""
    return _stub(vision_patches_shape(batch, d_model, patches), generator,
                 dtype, device)


def stub_inputs(cfg, generator: torch.Generator, batch: int, length: int,
                dtype, device) -> dict:
    """The frontend inputs of ``cfg``'s batch, as the reference's
    launchers build them: ``{"frames": (batch, length, d)}`` for an audio
    model, ``{"prefix_embeds": (batch, length, d)}`` for a vision one,
    ``{}`` otherwise."""
    if cfg.frontend == "audio":
        return {"frames": stub_audio_frontend(
            generator, batch, cfg.d_model, dtype, device=device,
            frames=length)}
    if cfg.frontend == "vision":
        return {"prefix_embeds": stub_vision_frontend(
            generator, batch, cfg.d_model, dtype, device=device,
            patches=length)}
    return {}
