"""Decoder-only LM (port of ``repro/models/model.py``).

    params = init(cfg, seed, dtype, device)
    loss, aux = loss_fn(cfg, params, batch[, remat=True])   # training
    logits, caches = prefill(cfg, params, batch, max_seq, cache_dtype)
    logits, caches = decode_step(cfg, params, caches, tokens, index)
    logits, caches = decode_step(cfg, params, caches, tokens,
                                 index_vector)               # verify window
    logits, caches = decode_step(cfg, params, caches, tokens, index,
                                 decode_mode="append_free")  # writes nothing
    pools = init_paged_cache(cfg, layout, cache_dtype)    # paged serving
    logits, pools = decode_step(cfg, params, pools, tokens, index_vector,
                                decode_mode="paged", block_table=table)

``params`` is a :class:`Model`; ``loss_fn`` takes a flat dict of
tensors keyed by its ``state_dict`` keys, which are the reference's
param-tree paths with the stacked pattern blocks split per block
(``stack.blocks.<block>.<position>.…``, see :mod:`repro_torch.convert`).
The simulation engine trains through that dict, one node's slice at a
time.  Caches and page pools are updated in place.  MoE models add the
router's aux loss to ``loss_fn``'s; an untied model projects through its
own ``lm_head.w``, and a multi-token-prediction model (deepseek-v3) adds
0.3 x its extra layer's loss on labels shifted one more
(``model.py:121-154``).  Encoder-decoder and frontend models are not
ported yet.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn

from repro_torch.configs.common import ArchConfig, LayerSpec
from repro_torch.device import resolve_device

from .blocks import Layer, Stack, stack_cache_init, stack_paged_cache_init
from .layers import Dense, Embed, RMSNorm, chunked_ce_loss
from .moe import MoE

DECODE_MODES = ("dus", "append_free", "paged")


#: the multi-token-prediction layer's spec (``model.py:81-88``)
MTP_SPEC = LayerSpec(kind="attn", ffn="dense")


class MTP(nn.Module):
    """deepseek's multi-token prediction: a norm and one extra attention +
    dense layer over the final hidden states, predicting token t + 2."""

    def __init__(self, cfg: ArchConfig, **kw):
        super().__init__()
        self.norm = RMSNorm(cfg.d_model, **kw)
        self.layer = Layer(cfg, MTP_SPEC, **kw)

    def forward(self, h):
        return self.layer(self.norm(h))[0]


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, *, dtype=torch.float32, device=None):
        super().__init__()
        if cfg.encoder is not None or cfg.frontend is not None:
            raise NotImplementedError(
                f"{cfg.name}: encoder and frontend models are not ported to "
                f"repro_torch yet; see ROADMAP.md")
        kw = dict(dtype=dtype, device=resolve_device(device))
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.d_model, **kw)
        self.stack = Stack(cfg, **kw)
        self.final_norm = RMSNorm(cfg.d_model, **kw)
        self.lm_head = None if cfg.tie_embeddings else Dense(
            cfg.d_model, cfg.vocab_size, **kw)
        self.mtp = MTP(cfg, **kw) if cfg.mtp else None

    def forward(self, tokens, remat=False):
        """A training forward (no cache): ``(h, aux, h_mtp)``, the
        final-normed hidden states (B, T, d_model), the f32 router aux
        loss and the MTP layer's hidden states (None without one), each
        pattern block checkpointed with ``remat``."""
        h, _, aux = backbone(self.cfg, self, tokens, remat=remat)
        return h, aux, None if self.mtp is None else self.mtp(h)


def init(cfg: ArchConfig, seed: int = 0, dtype=torch.float32,
         device=None) -> Model:
    """Random weights, N(0, 0.02) from a seeded ``torch.Generator`` on the
    target device (norm scales zero, as the reference).  The
    numbers differ from the reference's ``jax.random`` draws; parity runs
    carry the reference's weights across with ``convert.params_from_jax``.
    """
    model = Model(cfg, dtype=dtype, device=device)
    gen = torch.Generator(device=model.embed.table.device)
    gen.manual_seed(seed)
    for module in model.modules():
        if isinstance(module, (Dense, Embed, MoE)):
            module.reset_parameters(gen)
    return model.eval()


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> dict:
    return stack_cache_init(cfg, batch, max_seq, dtype,
                            resolve_device(device))


@dataclasses.dataclass(frozen=True)
class PagedCacheLayout:
    """Static shape of a paged KV cache (``model.py:167-198``, DESIGN.md
    Sec. 14).

    Each layer's pool holds ``num_pages`` pages of ``page_size``
    positions; every serve slot owns up to ``max_pages_per_slot`` pages
    through its block-table row, so a slot holds sequences up to
    ``max_seq = max_pages_per_slot * page_size``.  Page 0 is the scratch
    page free slots write into (``serve.paged.PagePool`` never hands it
    out)."""
    page_size: int = 8
    num_pages: int = 64
    max_pages_per_slot: int = 8

    def __post_init__(self):
        if self.page_size < 1 or self.num_pages < 2 \
                or self.max_pages_per_slot < 1:
            raise ValueError(f"invalid paged layout: {self}")
        if self.max_pages_per_slot > self.num_pages - 1:
            raise ValueError(
                f"max_pages_per_slot {self.max_pages_per_slot} exceeds the "
                f"{self.num_pages - 1} allocatable pages (page 0 is the "
                f"reserved scratch page)")

    @property
    def max_seq(self) -> int:
        return self.max_pages_per_slot * self.page_size

    def pages_for(self, n: int) -> int:
        """Pages needed to hold ``n`` positions (ceil)."""
        return -(-n // self.page_size)


def init_paged_cache(cfg: ArchConfig, layout: PagedCacheLayout,
                     dtype=torch.bfloat16, device=None) -> dict:
    """Page pools for paged serving: :func:`init_cache`'s structure with
    leaves ``(num_pages, page_size, KV, hd)``, to pair with a
    (B, max_pages) int32 block table and ``decode_mode="paged"``.
    Attention-family decoder-only models only; others raise."""
    if cfg.encoder is not None:
        raise NotImplementedError(
            "paged serving does not cover encoder-decoder models")
    return stack_paged_cache_init(cfg, layout.num_pages, layout.page_size,
                                  dtype, resolve_device(device))


def backbone(cfg: ArchConfig, params: Model, tokens, *, caches=None,
             cache_index=None, decode_mode="dus", block_table=None,
             num_blocks_limit=None, remat=False):
    """Returns ``(hidden, caches, aux)``, ``aux`` the f32 router aux loss.
    ``num_blocks_limit`` runs the prologue and the first n pattern blocks
    only (the self-speculative draft), sharing the final norm and head
    with the full model.  ``remat`` checkpoints each pattern block
    (training; no caches)."""
    x = params.embed(tokens)
    if cfg.embed_scale:
        # the constant is rounded to x's dtype before the multiply, as the
        # reference does: in bf16, sqrt(1152) = 33.94 becomes 34.0
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    x, caches, aux = params.stack(x, caches=caches, cache_index=cache_index,
                                  decode_mode=decode_mode,
                                  block_table=block_table,
                                  num_blocks_limit=num_blocks_limit,
                                  remat=remat)
    return params.final_norm(x), caches, aux


@functools.lru_cache(maxsize=8)
def _skeleton(cfg: ArchConfig) -> Model:
    """A parameterless :class:`Model` of ``cfg`` on the meta device, for
    ``torch.func.functional_call`` with a flat dict of tensors."""
    return Model(cfg, device="meta")


def loss_fn(cfg: ArchConfig, params, batch, *, remat=False):
    """Next-token cross-entropy of ``batch = {"tokens", "labels"}``
    (labels == -100 are ignored), plus the router aux loss and the MTP
    term, as ``model.py:121-154``: the final hidden states against the
    output projection (the tied embedding table, or ``lm_head.w``),
    chunked over positions in f32.  ``params`` is a flat dict of a
    :class:`Model`'s tensors (its ``state_dict`` keys).  ``remat``
    checkpoints each pattern block, as the reference's: the backward
    recomputes the block's forward (the flash kernel launches again
    there) in place of keeping its activations.  Returns ``(loss + aux,
    {"aux": aux})``, aux 0 without an MoE.  VLM prefix embeddings
    raise."""
    if batch.get("prefix_embeds") is not None:
        raise NotImplementedError(
            "prefix embeddings (VLM) are not ported to repro_torch yet; see "
            "ROADMAP.md")
    h, aux, h_mtp = torch.func.functional_call(
        _skeleton(cfg), params, (batch["tokens"],), {"remat": remat})
    w_out = params["embed.table"].T if cfg.tie_embeddings \
        else params["lm_head.w"]
    labels = batch["labels"]
    loss = chunked_ce_loss(h, w_out, labels, logit_softcap=cfg.final_softcap)
    if h_mtp is not None:
        # predict token t + 2: the labels shifted one step more
        l2 = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], -100)],
                       dim=1)
        loss = loss + 0.3 * chunked_ce_loss(h_mtp, w_out, l2,
                                            logit_softcap=cfg.final_softcap)
    return loss + aux, {"aux": aux}


def logits_of(cfg: ArchConfig, params: Model, h):
    """The output logits of final hidden states ``h`` (..., d_model),
    through the tied embedding table or the untied ``lm_head``."""
    logits = h @ (params.embed.table.T if params.lm_head is None
                  else params.lm_head.w)
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def prefill(cfg: ArchConfig, params: Model, batch, max_seq: int,
            cache_dtype=torch.bfloat16):
    """Run the prompt through the model, filling a fresh KV cache of
    ``max_seq`` positions.  Returns (last-position logits (B, 1, V),
    caches)."""
    tokens = batch["tokens"]
    caches = init_cache(cfg, tokens.shape[0], max_seq, cache_dtype,
                        tokens.device)
    h, caches, _ = backbone(cfg, params, tokens, caches=caches,
                            cache_index=0)
    return logits_of(cfg, params, h[:, -1:]), caches


def decode_step(cfg: ArchConfig, params: Model, caches, tokens, index, *,
                decode_mode="dus", block_table=None, draft_layers=None):
    """tokens: (B, T) at positions ``index .. index + T - 1`` (the cache
    holds [0, index)); T = 1 decodes, T = k + 1 is a speculative verify
    window.  ``decode_mode="dus"`` takes dense caches and an int
    ``index``, or a (B,) tensor of per-request positions (the fixed-batch
    speculative engine's draft steps and verify window);
    ``"append_free"`` takes an int ``index`` and T = 1, attends over the
    frozen cache and the fresh token and returns the caches untouched
    (with a (B,) index or T > 1 it writes as ``"dus"``, as the
    reference's); ``"paged"`` takes page pools, a (B,) tensor ``index`` of
    per-slot positions and ``block_table`` (B, max_pages) int32.
    ``draft_layers`` runs the self-speculative early exit (the first n
    pattern blocks).  Returns (logits (B, T, V), caches)."""
    if decode_mode not in DECODE_MODES:
        raise NotImplementedError(
            f"decode_mode {decode_mode!r} is not ported to repro_torch yet "
            f"(ported: {DECODE_MODES}); see ROADMAP.md")
    h, caches, _ = backbone(cfg, params, tokens, caches=caches,
                            cache_index=index, decode_mode=decode_mode,
                         block_table=block_table,
                         num_blocks_limit=draft_layers)
    return logits_of(cfg, params, h), caches
