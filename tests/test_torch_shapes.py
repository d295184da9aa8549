"""The shape table (``repro_torch.launch.shapes``) against the
reference's (``repro.launch.shapes``): every (arch x shape) gives the
reference's shapes and dtypes (train and prefill batches, the decode
tokens, index, encoder output and cache, the port's per-block cache
stacked back along the reference's ``num_blocks`` axis) and the same
skips; ``ArchConfig.sub_quadratic`` and ``long_context_variant`` equal
the reference's per arch."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch import shapes as JS
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch import shapes as S

N_NODES = 16


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _sig(x):
    return (tuple(x.shape), _dtype(x))


def _jsig(x):
    return (tuple(x.shape), np.dtype(x.dtype).name)


def _port_cache(cache):
    """The port's cache in the reference's layout: the prologue's layers
    as they are, each pattern position's leaves stacked over the blocks
    (``(shape, dtype)`` per leaf)."""
    def sig(tree):
        if isinstance(tree, dict):
            return {k: sig(v) for k, v in tree.items()}
        return _sig(tree)

    out = {"prologue": [sig(c) for c in cache["prologue"]]}
    blocks = cache["blocks"]
    out["blocks"] = [jax.tree.map(
        lambda s: ((len(blocks),) + s[0], s[1]), sig(layer),
        is_leaf=lambda x: isinstance(x, tuple))
        for layer in blocks[0]] if blocks else []
    return out


def _jcache(cache):
    return jax.tree.map(_jsig, cache)


def test_table_equals_reference():
    assert S.INPUT_SHAPES == JS.INPUT_SHAPES
    assert S.SHAPE_NAMES == JS.SHAPE_NAMES


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_schema_variants_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    assert cfg.sub_quadratic == jcfg.sub_quadratic
    for clamp in (32768, 4096):
        got = cfg.long_context_variant(clamp)
        want = jcfg.long_context_variant(clamp)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.sub_quadratic == want.sub_quadratic
            for a, b in zip(got.prologue + got.pattern,
                            want.prologue + want.pattern):
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert got.num_blocks == want.num_blocks


@pytest.mark.parametrize("shape", S.SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_shapes_equal_reference(arch, shape):
    cfg0, jcfg0 = get_config(arch), jget(arch)
    assert S.skip_reason(cfg0, shape) == JS.skip_reason(jcfg0, shape)
    if S.skip_reason(cfg0, shape):
        with pytest.raises(AssertionError):
            S.config_for_shape(cfg0, shape)
        return
    cfg = S.config_for_shape(cfg0, shape)
    jcfg = JS.config_for_shape(jcfg0, shape)
    assert [dataclasses.asdict(s) for s in cfg.prologue + cfg.pattern] == \
        [dataclasses.asdict(s) for s in jcfg.prologue + jcfg.pattern]
    info = S.INPUT_SHAPES[shape]
    B, seq = info["global_batch"], info["seq"]
    assert S.text_len(cfg, seq) == JS.text_len(jcfg, seq)
    if info["kind"] == "train":
        got = S.train_batch_shapes(cfg, N_NODES, seq=seq, global_batch=B)
        want = JS.train_batch_shapes(jcfg, N_NODES, seq=seq, global_batch=B)
    elif info["kind"] == "prefill":
        got = S.prefill_batch_shapes(cfg, batch=B, seq=seq)
        want = JS.prefill_batch_shapes(jcfg, batch=B, seq=seq)
    else:
        got = dict(zip(("cache", "tokens", "index", "enc"),
                       S.decode_inputs(cfg, batch=B, seq=seq)))
        want = dict(zip(("cache", "tokens", "index", "enc"),
                        JS.decode_inputs(jcfg, batch=B, seq=seq)))
        assert _port_cache(got.pop("cache")) == _jcache(want.pop("cache"))
        assert (got.pop("enc") is None) == (want["enc"] is None)
        if want["enc"] is not None:
            assert _sig(S.decode_inputs(cfg, batch=B, seq=seq)[3]) == \
                _jsig(want["enc"])
        want.pop("enc")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].device.type == "meta", k
        assert _sig(got[k]) == _jsig(want[k]), k


def test_meta_batches_hold_no_storage():
    cfg = get_config("llava-next-34b")
    b = S.train_batch_shapes(cfg, 2, seq=4096, global_batch=4)
    assert all(t.device.type == "meta" for t in b.values())
    assert b["tokens"].shape == (2, 2, 4096 - 2880)
    assert b["prefix_embeds"].dtype == torch.bfloat16
    assert S.decode_inputs(cfg, batch=1, seq=8)[2].dtype == torch.int32
    assert jnp.int32 == JS.decode_inputs(jget("gemma3-1b"), batch=1,
                                         seq=8)[2].dtype
