"""Layer / block composition: an unrolled prologue, then the repeated
pattern ``num_blocks`` times (port of ``repro/models/blocks.py``).

The reference stacks each pattern position's parameters along a leading
``num_blocks`` axis and runs the blocks as a ``lax.scan``; the port keeps
one module per block (``stack.blocks.<block>.<position>``) and loops.
With ``remat`` each pattern block runs under activation checkpointing,
as the reference's ``jax.checkpoint`` around the scan body
(``blocks.py:206``); prologue layers are not checkpointed.
Attention + dense-FFN layers, with or without QKV biases: mamba, MLA,
MoE and cross-attention layers raise ``NotImplementedError`` until they
are ported.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.common import ArchConfig, LayerSpec

from .attention import Attention
from .layers import MLP, RMSNorm


def _check_ported(cfg: ArchConfig, spec: LayerSpec) -> None:
    why = None
    if spec.kind != "attn":
        why = f"{spec.kind} layers"
    elif cfg.mla is not None:
        why = "MLA attention"
    elif spec.ffn == "moe":
        why = "MoE feed-forward layers"
    elif spec.cross_attn:
        why = "cross-attention layers"
    if why is not None:
        raise NotImplementedError(f"{why} are not ported to repro_torch yet "
                                  f"({cfg.name}); see ROADMAP.md")


class Layer(nn.Module):
    """One pre-norm residual layer (``layer_init`` / ``layer_apply``):
    attention, then a gated MLP, each with gemma's sandwich post-norm when
    ``cfg.post_norm``."""

    def __init__(self, cfg: ArchConfig, spec: LayerSpec, *, dtype, device):
        super().__init__()
        _check_ported(cfg, spec)
        self.cfg, self.spec = cfg, spec
        kw = dict(dtype=dtype, device=device)
        d = cfg.d_model
        self.ln1 = RMSNorm(d, **kw)
        self.attn = Attention(d, cfg.num_heads, cfg.num_kv_heads,
                              cfg.head_dim, qkv_bias=cfg.qkv_bias,
                              qk_norm=cfg.qk_norm, **kw)
        self.ln1_post = RMSNorm(d, **kw) if cfg.post_norm else None
        ffn = spec.ffn != "none"
        self.ln2 = RMSNorm(d, **kw) if ffn else None
        self.mlp = MLP(d, cfg.d_ff, act=cfg.mlp_act, **kw) if ffn else None
        self.ln2_post = RMSNorm(d, **kw) if ffn and cfg.post_norm else None

    def forward(self, x, *, cache=None, cache_index=None, decode_mode="dus",
                block_table=None):
        cfg, spec = self.cfg, self.spec
        a = self.attn(
            self.ln1(x), rope_theta=spec.rope_theta, window=spec.window,
            softcap=cfg.attn_softcap, scale=cfg.attn_scale,
            cache=None if cache is None else cache["attn"],
            cache_index=cache_index, decode_mode=decode_mode,
            block_table=block_table)
        if self.ln1_post is not None:
            a = self.ln1_post(a)
        x = x + a
        if self.mlp is not None:
            f = self.mlp(self.ln2(x))
            if self.ln2_post is not None:
                f = self.ln2_post(f)
            x = x + f
        return x


class Block(nn.ModuleList):
    """One copy of the pattern: its layers in order (a list, so the
    ``state_dict`` keys stay ``stack.blocks.<block>.<position>``)."""

    def forward(self, x):
        for layer in self:
            x = layer(x)
        return x


def _remat(block: Block, x):
    """``block(x)`` under activation checkpointing: only ``x`` is kept,
    and the backward runs the block's forward again.  Its parameters are
    inputs of the checkpoint, bound to the block through
    ``functional_call`` on each run: under ``model.loss_fn`` the block
    holds the caller's tensors only while the forward runs, not when the
    backward recomputes it."""
    names, tensors = zip(*block.named_parameters())

    def run(x, *ps):
        return torch.func.functional_call(block, dict(zip(names, ps)), (x,))

    return checkpoint(run, x, *tensors, use_reentrant=False)


class Stack(nn.Module):
    """Prologue layers, then ``num_blocks`` copies of the pattern
    (``stack_init`` / ``stack_apply``)."""

    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.prologue = nn.ModuleList(Layer(cfg, s, **kw)
                                      for s in cfg.prologue)
        self.blocks = nn.ModuleList(
            Block(Layer(cfg, s, **kw) for s in cfg.pattern)
            for _ in range(cfg.num_blocks))

    def forward(self, x, *, caches=None, cache_index=None, decode_mode="dus",
                block_table=None, num_blocks_limit=None, remat=False):
        """caches: ``{"prologue": [...], "blocks": [[...] per block]}``
        (updated in place, except in the ``"append_free"`` mode).
        ``cache_index`` (an int, or a (B,) tensor of per-request or
        per-slot positions), ``decode_mode`` and ``block_table`` go to
        every layer's attention as they are.  ``num_blocks_limit`` runs
        the prologue and only the first n pattern blocks, the
        self-speculative draft's early exit (``blocks.py:166-226``): the
        other blocks' caches are left as they are.  ``remat`` checkpoints
        each pattern block of a training forward (no caches).  Returns
        ``(x, caches)``."""
        if remat and caches is not None:
            raise ValueError("remat recomputes a training forward; it takes "
                             "no caches")
        blocks = self.blocks
        if num_blocks_limit is not None:
            if not 0 <= num_blocks_limit <= len(blocks):
                raise ValueError(f"num_blocks_limit must be in [0, "
                                 f"{len(blocks)}], got {num_blocks_limit}")
            blocks = blocks[:num_blocks_limit]
        kw = dict(cache_index=cache_index, decode_mode=decode_mode,
                  block_table=block_table)
        for i, layer in enumerate(self.prologue):
            c = None if caches is None else caches["prologue"][i]
            x = layer(x, cache=c, **kw)
        for b, block in enumerate(blocks):
            if remat:
                x = _remat(block, x)
                continue
            for i, layer in enumerate(block):
                c = None if caches is None else caches["blocks"][b][i]
                x = layer(x, cache=c, **kw)
        return x, caches


def layer_cache_init(cfg: ArchConfig, spec: LayerSpec, batch: int,
                     max_seq: int, dtype, device) -> dict:
    _check_ported(cfg, spec)
    shape = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"attn": {"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device)}}


def stack_cache_init(cfg: ArchConfig, batch: int, max_seq: int, dtype,
                     device) -> dict:
    return {
        "prologue": [layer_cache_init(cfg, s, batch, max_seq, dtype, device)
                     for s in cfg.prologue],
        "blocks": [[layer_cache_init(cfg, s, batch, max_seq, dtype, device)
                    for s in cfg.pattern] for _ in range(cfg.num_blocks)],
    }


def stack_paged_cache_init(cfg: ArchConfig, num_pages: int, page_size: int,
                           dtype, device) -> dict:
    """Page pools with :func:`stack_cache_init`'s structure: each layer's
    k/v is a pool ``(num_pages, page_size, KV, hd)`` shared by every slot
    through the block table (``blocks.py:228-276``)."""
    # a pool is a cache of num_pages rows of page_size positions
    return stack_cache_init(cfg, num_pages, page_size, dtype, device)


def layer_caches(caches: dict):
    """Every layer's ``{"k", "v"}`` cache, prologue first, then the blocks
    in order."""
    for c in caches["prologue"]:
        yield c["attn"]
    for block in caches["blocks"]:
        for c in block:
            yield c["attn"]
