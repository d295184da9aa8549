"""Carry the reference's parameters into the port.

The JAX model's params are a pytree of dicts and lists whose paths are
the port's ``state_dict`` keys, with one difference: the repeated pattern
blocks are stacked in the reference (``stack.blocks[i]`` leaves carry a
leading ``num_blocks`` axis, ``blocks.py:146-160``) and are one module
per block here (``stack.blocks.<block>.<i>``).  Weight orientation is the
same on both sides, so each leaf is a copy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.common import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import Model


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)                    # a writable copy
    if a.dtype.name == "bfloat16":     # ml_dtypes' bf16: carry the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree, cfg: ArchConfig, *, device=None,
                    dtype=torch.float32) -> Model:
    """A :class:`Model` holding the reference's parameter pytree ``tree``
    (leaves as numpy arrays), cast to ``dtype`` on ``device``."""
    state = {}
    for name, arr in _leaves(tree):
        if name.startswith("stack.blocks."):
            _, _, pos, rest = name.split(".", 3)
            if arr.shape[0] != cfg.num_blocks:
                raise ValueError(f"{name}: leading axis {arr.shape[0]} != "
                                 f"num_blocks {cfg.num_blocks}")
            for b in range(cfg.num_blocks):
                state[f"stack.blocks.{b}.{pos}.{rest}"] = _to_torch(arr[b])
        else:
            state[name] = _to_torch(arr)
    model = Model(cfg, dtype=dtype, device=resolve_device(device))
    model.load_state_dict(state, strict=True)
    return model.eval()
