"""Decoder-only LM and encoder-decoder (port of ``repro/models/model.py``).

    params = init(cfg, seed, dtype, device)
    loss, aux = loss_fn(cfg, params, batch[, remat=True])   # training
    logits, caches = prefill(cfg, params, batch, max_seq, cache_dtype)
    enc_out = encode(cfg, params, frames)                  # encoder only
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
(``model.py:121-154``).  SSM and hybrid models (mamba2, jamba) run
their Mamba layers' chunked scan in prefill, ``loss_fn`` and a decode
step of T > 1 tokens (continued from the cached state), and the
recurrent step at T = 1; their state ignores the index and is updated in
every decode mode, ``"append_free"`` included.

Batches are dicts: ``{"tokens", "labels"}``, plus ``"prefix_embeds"``
(B, P, d_model) for a vision model (llava-next-34b: the embeddings go in
front of the token embeddings, and ``loss_fn`` gives them ``-100``
labels) or ``"frames"`` (B, S_src, d_model) for an encoder-decoder
(seamless-m4t-large-v2: the encoder runs over them non-causally, and each
decoder layer's cross-attention attends over its output).  The encoder
output is serve state: ``prefill`` returns it in the caches dict under
``"enc_out"``, and ``decode_step`` reads it from there.
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
from .mamba2 import Mamba
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


def _enc_cfg(cfg: ArchConfig) -> ArchConfig:
    """The encoder stack as an ArchConfig (``model.py:28-35``): one dense
    attention layer a block, ``encoder.num_layers`` blocks, the encoder's
    d_ff, no prologue, MoE, MLA or SSM."""
    return dataclasses.replace(
        cfg, pattern=(LayerSpec(kind="attn", ffn="dense"),), prologue=(),
        num_blocks=cfg.encoder.num_layers, d_ff=cfg.encoder.d_ff, moe=None,
        mla=None, ssm=None)


class Encoder(nn.Module):
    """The encoder of an encoder-decoder: a :class:`Stack` of
    :func:`_enc_cfg` and its final norm (``encoder.stack``,
    ``encoder.final_norm``)."""

    def __init__(self, cfg: ArchConfig, **kw):
        super().__init__()
        self.stack = Stack(_enc_cfg(cfg), **kw)
        self.final_norm = RMSNorm(cfg.d_model, **kw)


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=resolve_device(device))
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.d_model, **kw)
        self.stack = Stack(cfg, **kw)
        self.final_norm = RMSNorm(cfg.d_model, **kw)
        self.lm_head = None if cfg.tie_embeddings else Dense(
            cfg.d_model, cfg.vocab_size, **kw)
        self.encoder = Encoder(cfg, **kw) if cfg.encoder is not None \
            else None
        self.mtp = MTP(cfg, **kw) if cfg.mtp else None

    def forward(self, tokens, remat=False, prefix_embeds=None, frames=None):
        """A training forward (no cache): ``(h, aux, h_mtp)``, the
        final-normed hidden states (B, P + T, d_model) over the prefix
        embeddings and the tokens, the f32 router aux loss and the MTP
        layer's hidden states (None without one), each pattern block of
        the decoder checkpointed with ``remat`` (the encoder is not, as
        the reference's ``encode``).  An encoder model takes
        ``frames``."""
        enc_out = None if frames is None else encode(self.cfg, self, frames)
        h, _, aux = backbone(self.cfg, self, tokens,
                             prefix_embeds=prefix_embeds, enc_out=enc_out,
                             remat=remat)
        return h, aux, None if self.mtp is None else self.mtp(h)


def init(cfg: ArchConfig, seed: int = 0, dtype=torch.float32,
         device=None) -> Model:
    """Random weights, N(0, 0.02) from a seeded ``torch.Generator`` on the
    target device (norm scales zero, as the reference; a Mamba layer's
    ``conv_w`` N(0, 0.1), its ``D`` 1 and its other leaves zero).  The
    numbers differ from the reference's ``jax.random`` draws; parity runs
    carry the reference's weights across with ``convert.params_from_jax``.
    """
    model = Model(cfg, dtype=dtype, device=device)
    gen = torch.Generator(device=model.embed.table.device)
    gen.manual_seed(seed)
    for module in model.modules():
        if isinstance(module, (Dense, Embed, MoE, Mamba)):
            module.reset_parameters(gen)
    return model.eval()


def param_specs(cfg: ArchConfig, dtype=torch.bfloat16) -> dict:
    """Each parameter's shape and dtype without allocating
    (``model.py:67``): the ``state_dict`` of a :class:`Model` on the meta
    device."""
    return Model(cfg, dtype=dtype, device="meta").state_dict()


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
    Attention-family decoder-only models only; others (MLA, any Mamba
    layer, an encoder, a cross-attention layer) raise."""
    if cfg.encoder is not None:
        raise NotImplementedError(
            "paged serving does not cover encoder-decoder models")
    return stack_paged_cache_init(cfg, layout.num_pages, layout.page_size,
                                  dtype, resolve_device(device))


def encode(cfg: ArchConfig, params: Model, frames):
    """The encoder over ``frames`` (B, S_src, d_model), the stub
    frontend's embeddings cast to the parameters' dtype: its stack with
    ``causal=False``, then its final norm (``model.py:91-96``)."""
    x, _, _ = params.encoder.stack(frames.to(params.embed.table.dtype),
                                   causal=False)
    return params.encoder.final_norm(x)


def backbone(cfg: ArchConfig, params: Model, tokens, *, prefix_embeds=None,
             enc_out=None, caches=None, cache_index=None, decode_mode="dus",
             block_table=None, num_blocks_limit=None, remat=False):
    """Returns ``(hidden, caches, aux)``, ``aux`` the f32 router aux loss.
    ``prefix_embeds`` (B, P, d_model), cast to the activations' dtype, go
    in front of the (scaled) token embeddings; ``enc_out`` goes to the
    cross-attention layers.  ``num_blocks_limit`` runs the prologue and
    the first n pattern blocks only (the self-speculative draft), sharing
    the final norm and head with the full model.  ``remat`` checkpoints
    each pattern block (training; no caches)."""
    x = params.embed(tokens)
    if cfg.embed_scale:
        # the constant is rounded to x's dtype before the multiply, as the
        # reference does: in bf16, sqrt(1152) = 33.94 becomes 34.0
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    x, caches, aux = params.stack(x, caches=caches, cache_index=cache_index,
                                  decode_mode=decode_mode,
                                  block_table=block_table,
                                  num_blocks_limit=num_blocks_limit,
                                  remat=remat, enc_out=enc_out)
    return params.final_norm(x), caches, aux


@functools.lru_cache(maxsize=8)
def _skeleton(cfg: ArchConfig) -> Model:
    """A parameterless :class:`Model` of ``cfg`` on the meta device, for
    ``torch.func.functional_call`` with a flat dict of tensors."""
    return Model(cfg, device="meta")


def loss_fn(cfg: ArchConfig, params, batch, *, remat=False, model=None):
    """Next-token cross-entropy of ``batch = {"tokens", "labels"}``
    (labels == -100 are ignored), plus the router aux loss and the MTP
    term, as ``model.py:121-154``: the final hidden states against the
    output projection (the tied embedding table, or ``lm_head.w``),
    chunked over positions in f32.  ``params`` is a flat dict of a
    :class:`Model`'s tensors (its ``state_dict`` keys).  ``remat``
    checkpoints each pattern block, as the reference's: the backward
    recomputes the block's forward (the flash kernel launches again
    there) in place of keeping its activations.  A vision batch's
    ``prefix_embeds`` positions get ``-100`` labels in front of
    ``labels``; an encoder model encodes ``batch["frames"]``.  Returns
    ``(loss + aux, {"aux": aux})``, aux 0 without an MoE.

    ``model`` is the module ``params`` is called through (a parameterless
    skeleton of ``cfg`` by default).  A tensor-parallel rank passes the
    marked skeleton of ``dist.tp.bind(cfg, None, mesh, context="train")``
    and its shards: the forward then runs the sharded layers, the output
    projection is the sharded f32 contraction chunk by chunk, and the
    summed losses and counts are added over the axes that split the
    batch rows (``dist.tp.Collectives.row_axes``), so the loss is the
    node's whole-batch mean on every rank."""
    prefix = batch.get("prefix_embeds")
    kw = {"remat": remat, "prefix_embeds": prefix}
    if cfg.encoder is not None:
        kw["frames"] = batch["frames"]
    skel = _skeleton(cfg) if model is None else model
    h, aux, h_mtp = torch.func.functional_call(
        skel, params, (batch["tokens"],), kw)
    w_out = params["embed.table"].T if cfg.tie_embeddings \
        else params["lm_head.w"]
    ce = {"logit_softcap": cfg.final_softcap}
    comm = getattr(skel, "tp", None)
    if comm is not None:
        head = skel.embed if cfg.tie_embeddings else skel.lm_head
        if head.tp is not None and cfg.tie_embeddings:
            ce["project"] = head.tp.head_f32(params["embed.table"])
        elif head.tp is not None:
            ce["project"] = head.tp.dense_f32(params["lm_head.w"])
        if comm.row_axes:
            ce["reduce"] = lambda tot, cnt: (comm.sum_rows(tot),
                                             comm.sum_rows(cnt))
    labels = batch["labels"]
    if prefix is not None:
        ignore = torch.full(labels.shape[:1] + prefix.shape[1:2], -100,
                            dtype=labels.dtype, device=labels.device)
        labels = torch.cat([ignore, labels], dim=1)
    loss = chunked_ce_loss(h, w_out, labels, **ce)
    if h_mtp is not None:
        # predict token t + 2: the labels shifted one step more
        l2 = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], -100)],
                       dim=1)
        loss = loss + 0.3 * chunked_ce_loss(h_mtp, w_out, l2, **ce)
    return loss + aux, {"aux": aux}


def logits_of(cfg: ArchConfig, params: Model, h):
    """The output logits of final hidden states ``h`` (..., d_model),
    through the tied embedding table or the untied ``lm_head``."""
    table = params.embed.table
    if params.lm_head is not None:
        logits = params.lm_head(h)
    elif params.embed.tp is not None:
        logits = params.embed.tp.head(table, h)
    else:
        logits = h @ table.T
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def prefill(cfg: ArchConfig, params: Model, batch, max_seq: int,
            cache_dtype=torch.bfloat16):
    """Run the prompt (after ``batch["prefix_embeds"]``, if any) through
    the model, filling a fresh KV cache of ``max_seq`` positions; an
    encoder model first encodes ``batch["frames"]`` and keeps the output
    in the caches, under ``"enc_out"``.  Returns (last-position logits
    (B, 1, V), caches)."""
    tokens = batch["tokens"]
    enc_out = None
    if cfg.encoder is not None:
        enc_out = encode(cfg, params, batch["frames"])
    caches = init_cache(cfg, tokens.shape[0], max_seq, cache_dtype,
                        tokens.device)
    h, caches, _ = backbone(cfg, params, tokens,
                            prefix_embeds=batch.get("prefix_embeds"),
                            enc_out=enc_out, caches=caches, cache_index=0)
    if enc_out is not None:
        caches["enc_out"] = enc_out
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
    pattern blocks).  An encoder model's cross-attention reads the
    encoder output from ``caches["enc_out"]`` (``prefill`` put it there).
    Returns (logits (B, T, V), caches)."""
    if decode_mode not in DECODE_MODES:
        raise NotImplementedError(
            f"decode_mode {decode_mode!r} is not ported to repro_torch yet "
            f"(ported: {DECODE_MODES}); see ROADMAP.md")
    h, caches, _ = backbone(cfg, params, tokens,
                            enc_out=caches.get("enc_out"), caches=caches,
                            cache_index=index, decode_mode=decode_mode,
                            block_table=block_table,
                            num_blocks_limit=draft_layers)
    return logits_of(cfg, params, h), caches
