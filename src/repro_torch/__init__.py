"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper.

``repro`` (JAX, Pallas kernels for the TPU) is the reference and stays
as it is.  This package imports ``torch`` and nothing of ``jax`` or
``repro``; it keeps its own copy of what it needs.  Module names mirror
the reference's, so each module's counterpart is found by its path.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
On the card, every kernel of the path is a hand-written CUDA kernel
(``repro_torch/kernels/csrc``); on the CPU the same entry points use the
kernels' plain PyTorch versions.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
