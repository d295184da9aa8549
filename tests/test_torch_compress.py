"""The port's compressed gossip (``repro_torch.compress`` and the plain
quantize+EF version in ``repro_torch.kernels.ref``) against the
reference's ``repro.compress`` and ``repro.kernels.ref``, on the CPU.

Inputs come from numpy seeds and go through both sides.  Tolerances:
- payload bits (int8 / fp8 q and scale, int4's packed nibbles and
  scales, top-k's indices and values) and the hash are compared bit for
  bit: they are the wire contract (DESIGN.md Sec. 13);
- the EF residual of the plain versions is compared bit for bit too (the
  same f32 steps on both sides); the reference's interpret-mode Pallas
  kernel is held at its own test's tolerance, 1e-6 on the residual
  (``tests/test_compress.py:184``);
- ``compressed_dense_mix``'s mixed values within 1e-6 (max abs): the
  (n x n) product sums in another order; its new residual bit for bit.
  That holds on the reference's own stacked tree too: the port's
  per-block tensors of one stacked leaf are quantized together.
- the dequantize-and-combine of a compressed round
  (``ref.quantized_gossip_mix_ref``) equals the reference's oracle bit
  for bit (the same f32 steps in the same order, every fp8 code decoded
  alike), and the interpret-mode Pallas kernel within 4 f32 ulps of the
  terms' magnitude ``|w0 own| + sum_s |w_s q_s scale_s|``: XLA may
  contract its products and sums into FMAs (ROADMAP queue 3).
- the grouped entry points (``ops.quantize_payload_many``,
  ``ops.quantized_gossip_mix_many``) on the CPU equal the reference's
  oracles leaf by leaf, bit for bit, each leaf at its own row offset, and
  its interpret-mode kernels at the tolerances above; the bucketed
  ``compressed_dense_mix`` equals one bucket per leaf bit for bit and the
  reference on a reduced gemma3-1b at the tolerances above.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compress as J
from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.kernels import ref as jref
from repro.kernels.quantized_gossip import (
    quantize_ef_pallas, quantized_gossip_mix_slots_pallas)
from repro.optim.decentralized import mix as jmix
from repro.topology import TopologySpec as JSpec
from repro.topology import build_schedule as jbuild
from repro_torch import compress as T
from repro_torch.compress import mixing as tmixing
from repro_torch.convert import tree_from_jax
from repro_torch.kernels.multi_tensor import plan_buckets
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.optim.decentralized import mix

LOSSY = ("int8", "fp8", "int4", "topk")


def _rows(r, c, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((r, c))).astype(np.float32)


def _bits(a):
    """The raw bytes of a numpy or torch array, for exact comparison."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous().view(torch.uint8).numpy()
    else:
        a = np.ascontiguousarray(np.asarray(a)).view(np.uint8)
    return a


def _same_bits(got, want):
    g, w = _bits(got), _bits(want)
    return g.shape == w.shape and np.array_equal(g, w)


# ---------------------------------------------------------------------------
# CompressionConfig
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", J.CODEC_NAMES)
def test_config_matches_reference(codec):
    assert T.CODEC_NAMES == J.CODEC_NAMES
    assert T.UNCOMPRESSED_BYTES_PER_PARAM == J.UNCOMPRESSED_BYTES_PER_PARAM
    for kw in ({}, {"chunk": 32}, {"chunk": 128, "topk_frac": 0.1,
                                   "error_feedback": False, "seed": 3}):
        want = J.CompressionConfig(codec=codec, **kw)
        got = T.CompressionConfig(codec=codec, **kw)
        assert got.to_json() == want.to_json()
        assert got.to_dict() == want.to_dict()
        assert T.CompressionConfig.from_json(want.to_json()) == got
        assert hash(got) == hash(T.CompressionConfig.from_dict(
            got.to_dict()))
        assert got.is_identity == want.is_identity
        assert got.topk_m == want.topk_m
        for p in (1, 255, 256, 257, 1000, 1152, 10 ** 6):
            assert got.rows(p) == want.rows(p)
            assert got.wire_bytes(p) == want.wire_bytes(p)
            assert got.compression_ratio(p) == want.compression_ratio(p)
        assert (T.resolve(got) is None) == (J.resolve(want) is None)
    cli = T.CompressionConfig.from_cli(codec)
    assert cli.to_json() == J.CompressionConfig.from_cli(codec).to_json()
    with pytest.raises(Exception):
        cli.chunk = 64          # frozen


@pytest.mark.parametrize("form", [None, "", "none", "NONE ", "int8",
                                  '{"codec": "topk", "topk_frac": 0.1}',
                                  "identity"])
def test_cli_forms_and_resolve_match_reference(form):
    got, want = T.CompressionConfig.from_cli(form), \
        J.CompressionConfig.from_cli(form)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.to_json() == want.to_json()
    rg, rw = T.resolve(form), J.resolve(form)
    assert (rg is None) == (rw is None)
    if rw is not None:
        assert rg.to_json() == rw.to_json()
    cfg = T.CompressionConfig(codec="fp8")
    assert T.CompressionConfig.from_cli(cfg) is cfg and T.resolve(cfg) is cfg


@pytest.mark.parametrize("kw", [dict(codec="int2"), dict(chunk=1),
                                dict(codec="int4", chunk=255),
                                dict(codec="topk", topk_frac=0.0),
                                dict(codec="topk", topk_frac=1.5)])
def test_config_validation_matches_reference(kw):
    with pytest.raises(ValueError) as want:
        J.CompressionConfig(**kw)
    with pytest.raises(ValueError) as got:
        T.CompressionConfig(**kw)
    assert str(got.value) == str(want.value)


def test_registry_covers_config_names():
    assert set(T.CODECS) == set(T.CODEC_NAMES)
    with pytest.raises(ValueError, match="unknown codec"):
        T.get_codec("int2")


# ---------------------------------------------------------------------------
# the stochastic-rounding hash
# ---------------------------------------------------------------------------

_IDX = np.array([0, 1, 2, 255, 256, 2 ** 31 - 2, 2 ** 31 - 1, 2 ** 31,
                 2 ** 31 + 1, 2 ** 32 - 257, 2 ** 32 - 2, 2 ** 32 - 1,
                 123456789, 3000000000], np.uint64)


@pytest.mark.parametrize("seed,t", [(0, 0), (0, 1), (3, 9), (7, 3),
                                    (12345, 2 ** 31 - 1), (2 ** 32 - 1, 5)])
def test_sr_key_and_bits_bitwise(seed, t):
    key = tref.sr_key(seed, t)
    want_key = jref.sr_key(np.uint32(seed), np.uint32(t))
    assert key == int(want_key) and key & 1
    want = np.asarray(jref._sr_bits(want_key,
                                    jnp.asarray(_IDX.astype(np.uint32))))
    got = tref._sr_bits(key, torch.from_numpy(_IDX.astype(np.int64)))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("R,C,off", [(3, 32, 0), (4, 256, 2 ** 23 - 2),
                                     (5, 250, 17179868), (2, 7, -3)])
def test_element_index_wraps_as_the_references_int32(R, C, off):
    """((row + row_offset) * C + col) mod 2^32, across 2^31 and 2^32."""
    rows = np.arange(R, dtype=np.int64)[:, None] + off
    want = (rows * C + np.arange(C)[None, :]) % (1 << 32)
    got = tref.element_index(R, C, off, "cpu").numpy()
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# quantize_ef_ref against the reference (and its interpret-mode kernel)
# ---------------------------------------------------------------------------

def _quant_inputs(shape, with_err, case):
    R, C = shape
    x = _rows(R, C, 11 + R * C)
    if case == "zero-rows":
        x[::2] = 0.0
    if case == "subnormal":
        # entries far below amax * 2^-6 / 448: e4m3's subnormal range
        x[:, 0] = 3.0
        x[:, 1:] *= 1e-5
    err = 0.1 * _rows(R, C, 12 + R * C) if with_err else None
    if with_err and case == "zero-rows":
        err[::2] = 0.0
    return x, err


def _ref_both(x, err, key, off, fmt):
    want = jref.quantize_ef_ref(jnp.asarray(x),
                                None if err is None else jnp.asarray(err),
                                jnp.uint32(key), off, fmt=fmt)
    got = tref.quantize_ef_ref(torch.from_numpy(x),
                               None if err is None else torch.from_numpy(err),
                               key, off, fmt=fmt)
    return got, want


@pytest.mark.parametrize("with_err", [False, True])
@pytest.mark.parametrize("off", [0, 5, 2 ** 24 - 2])
@pytest.mark.parametrize("shape", [(1, 8), (3, 32), (7, 128), (5, 256)])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantize_ef_ref_bitwise(fmt, shape, off, with_err):
    x, err = _quant_inputs(shape, with_err, None)
    key = tref.sr_key(3, 9)
    (q, s, r), (jq, js, jr) = _ref_both(x, err, key, off, fmt)
    assert q.dtype == {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[fmt]
    assert s.shape == (shape[0], 1) and s.dtype == torch.float32
    assert _same_bits(q, jq) and _same_bits(s, js) and _same_bits(r, jr)


@pytest.mark.parametrize("case", ["zero-rows", "subnormal"])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantize_ef_ref_edges_bitwise(fmt, case):
    x, err = _quant_inputs((6, 64), True, case)
    if case == "subnormal":
        err = None
    key = tref.sr_key(1, 4)
    (q, s, r), (jq, js, jr) = _ref_both(x, err, key, 0, fmt)
    assert _same_bits(q, jq) and _same_bits(s, js) and _same_bits(r, jr)
    if case == "zero-rows":
        assert bool((s[::2] == 1.0).all()) and not bool(q[::2].float().any())
    elif fmt == "fp8":
        v = np.abs(x[:, 1:] / s.numpy())
        assert v.max() < 2.0 ** -6          # all in e4m3's subnormal range
        assert bool(q[:, 1:].float().any())  # and not all flushed to zero


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("shape", [(1, 8), (3, 32), (7, 128), (5, 256)])
def test_quantize_ef_ref_matches_interpret_kernel(fmt, shape):
    x, err = _quant_inputs(shape, True, None)
    key = tref.sr_key(3, 9)
    jq, js, jr = quantize_ef_pallas(jnp.asarray(x), jnp.asarray(err),
                                    jnp.uint32(key), jnp.int32(5), fmt=fmt,
                                    interpret=True)
    q, s, r = tref.quantize_ef_ref(torch.from_numpy(x),
                                   torch.from_numpy(err), key, 5, fmt=fmt)
    assert _same_bits(q, jq) and _same_bits(s, js)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0, atol=1e-6)


def _qmix_inputs(fmt, S, R=9, C=256, seed=0, sweep=True):
    """Payloads as the quantizer makes them, the last one of all zeros
    (a slot this node receives nothing in, at weight 0); for fp8 (and
    ``sweep``) the first row holds every byte value of e4m3 except its
    two NaNs."""
    rng = np.random.default_rng(seed)
    own = rng.standard_normal((R, C)).astype(np.float32)
    qs, scales = [], []
    for s in range(S):
        x = rng.standard_normal((R, C)).astype(np.float32)
        q, sc, _ = tref.quantize_ef_ref(torch.from_numpy(x), None,
                                        tref.sr_key(1, s), 0, fmt=fmt)
        if fmt == "fp8" and s == 0 and sweep:
            codes = np.asarray([b for b in range(256)
                                if b & 0x7F != 0x7F], np.uint8)
            q = q.clone()
            q.view(torch.uint8)[0, :codes.size] = torch.from_numpy(codes)
        if s == S - 1 and S > 1:
            q, sc = torch.zeros_like(q), torch.zeros_like(sc)
        qs.append(q)
        scales.append(sc)
    w = rng.random(S + 1).astype(np.float32)
    if S > 1:
        w[-1] = 0.0
    return own, qs, scales, w


def _jpayload(q):
    dt = jnp.int8 if q.dtype == torch.int8 else jnp.float8_e4m3fn
    return jnp.asarray(q.view(torch.uint8).numpy()).view(dt)


@pytest.mark.parametrize("S", [0, 1, 2, 3])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantized_gossip_mix_ref_matches_reference(fmt, S):
    own, qs, scales, w = _qmix_inputs(fmt, S)
    got = tref.quantized_gossip_mix_ref(torch.from_numpy(own), qs, scales,
                                        w.tolist())
    jq = [_jpayload(q) for q in qs]
    js = [jnp.asarray(sc.numpy()) for sc in scales]
    want = jref.quantized_gossip_mix_ref(jnp.asarray(own), jq, js,
                                         jnp.asarray(w))
    assert got.dtype == torch.float32
    assert _same_bits(got, np.asarray(want, np.float32))
    disp = ops.quantized_gossip_mix(torch.from_numpy(own), qs, scales,
                                    torch.from_numpy(w))
    assert _same_bits(disp, got)
    if S:
        kern = np.asarray(quantized_gossip_mix_slots_pallas(
            jnp.asarray(own), tuple(jq), tuple(js), jnp.asarray(w),
            interpret=True))
        terms = np.abs(w[0] * own) + sum(
            np.abs(w[s + 1] * q.float().numpy() * sc.numpy())
            for s, (q, sc) in enumerate(zip(qs, scales)))
        ulps = np.abs(got.numpy().astype(np.float64) - kern) / np.spacing(
            np.maximum(terms, 1e-30).astype(np.float32))
        assert ulps.max() <= 4


def test_quantized_gossip_mix_takes_its_shapes():
    own, qs, scales, w = _qmix_inputs("int8", 2)
    with pytest.raises(ValueError):
        tref.quantized_gossip_mix_ref(torch.from_numpy(own), qs, scales,
                                      w[:2].tolist())
    with pytest.raises(ValueError):
        tref.quantized_gossip_mix_ref(torch.from_numpy(own), qs,
                                      scales[:1], w.tolist())


def test_codecs_fused_mix_match_reference():
    for name in J.CODEC_NAMES:
        assert T.get_codec(name).fused_mix == J.get_codec(name).fused_mix


def test_quantize_payload_dispatches_by_device():
    x = torch.from_numpy(_rows(3, 16, 0))
    got = ops.quantize_payload(x, None, fmt="fp8", key=7, row_offset=2)
    want = tref.quantize_ef_ref(x, None, 7, 2, fmt="fp8")
    assert all(_same_bits(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="fmt"):
        ops.quantize_payload(x, fmt="int4", key=7)


# ---------------------------------------------------------------------------
# the grouped entry points on the CPU, leaf by leaf against the reference
# ---------------------------------------------------------------------------

# (R, C, row_offset) per buffer of a bucket: whole and partial chunks,
# indices across 2^31 and 2^32 (the reference's int32 index wraps)
MANY_SHAPES = [(5, 256, 0), (1, 8, 3), (7, 128, 2 ** 24 - 2), (3, 32, 5),
               (4, 256, 2 ** 23 - 1), (2, 250, 17179868)]


def _many_inputs(with_err, case=None):
    xs, errs, offs = [], [], []
    for i, (R, C, off) in enumerate(MANY_SHAPES):
        x, err = _quant_inputs((R, C), with_err in (True, "some"), case)
        if with_err == "some" and i % 2:
            err = None
        xs.append(x)
        errs.append(err)
        offs.append(off)
    return xs, errs, offs


@pytest.mark.parametrize("with_err", [False, True, "some"])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantize_payload_many_matches_reference_per_leaf(fmt, with_err):
    xs, errs, offs = _many_inputs(with_err)
    key = tref.sr_key(2, 7)
    got = ops.quantize_payload_many(
        [torch.from_numpy(x) for x in xs],
        [None if e is None else torch.from_numpy(e) for e in errs],
        fmt=fmt, key=key, row_offsets=offs)
    assert all(len(g) == len(xs) for g in got)
    for x, e, off, q, s, r in zip(xs, errs, offs, *got):
        jq, js, jr = jref.quantize_ef_ref(
            jnp.asarray(x), None if e is None else jnp.asarray(e),
            jnp.uint32(key), off, fmt=fmt)
        assert _same_bits(q, jq) and _same_bits(s, js) and _same_bits(r, jr)
    # the codec's grouped call: the same payloads and residuals
    pays, res = T.get_codec(fmt).compress_many(
        T.CompressionConfig(codec=fmt), [torch.from_numpy(x) for x in xs],
        [None if e is None else torch.from_numpy(e) for e in errs], key,
        offs)
    for p, r, q, s, rr in zip(pays, res, *got):
        assert _same_bits(p["q"], q) and _same_bits(p["scale"], s)
        assert _same_bits(r, rr)


@pytest.mark.parametrize("case", ["zero-rows", "subnormal"])
def test_quantize_payload_many_edges_match_reference(case):
    xs, errs, offs = _many_inputs(case == "zero-rows", case)
    key = tref.sr_key(1, 4)
    got = ops.quantize_payload_many(
        [torch.from_numpy(x) for x in xs],
        None if case == "subnormal" else [torch.from_numpy(e) for e in errs],
        fmt="fp8", key=key, row_offsets=offs)
    for x, e, off, q, s, r in zip(xs, errs, offs, *got):
        jq, js, jr = jref.quantize_ef_ref(
            jnp.asarray(x), None if e is None else jnp.asarray(e),
            jnp.uint32(key), off, fmt="fp8")
        assert _same_bits(q, jq) and _same_bits(s, js) and _same_bits(r, jr)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantize_payload_many_matches_interpret_kernel(fmt):
    xs, errs, offs = _many_inputs(True)
    xs, errs, offs = xs[:4], errs[:4], offs[:4]
    key = tref.sr_key(3, 9)
    got = ops.quantize_payload_many(
        [torch.from_numpy(x) for x in xs], [torch.from_numpy(e)
                                            for e in errs],
        fmt=fmt, key=key, row_offsets=offs)
    for x, e, off, q, s, r in zip(xs, errs, offs, *got):
        jq, js, jr = quantize_ef_pallas(jnp.asarray(x), jnp.asarray(e),
                                        jnp.uint32(key), jnp.int32(off),
                                        fmt=fmt, interpret=True)
        assert _same_bits(q, jq) and _same_bits(s, js)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0,
                                   atol=1e-6)


def test_quantize_payload_many_takes_matching_lists():
    x = torch.from_numpy(_rows(3, 16, 0))
    assert ops.quantize_payload_many([], fmt="int8", key=1,
                                     row_offsets=[]) == ([], [], [])
    with pytest.raises(ValueError, match="row offsets"):
        ops.quantize_payload_many([x, x], fmt="int8", key=1, row_offsets=[0])
    with pytest.raises(ValueError, match="err"):
        ops.quantize_payload_many([x, x], [x], fmt="int8", key=1,
                                  row_offsets=[0, 0])
    with pytest.raises(ValueError, match="fmt"):
        ops.quantize_payload_many([x], fmt="int4", key=1, row_offsets=[0])
    with pytest.raises(ValueError, match="one device"):
        ops.quantize_payload_many([x, x.to("meta")], fmt="int8", key=1,
                                  row_offsets=[0, 0])


@pytest.mark.parametrize("S", [0, 1, 2, 3])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantized_gossip_mix_many_matches_reference_per_leaf(fmt, S):
    leaves = [_qmix_inputs(fmt, S, R, C, seed=R, sweep=C >= 256)
              for R, C in ((9, 256), (3, 32), (1, 8), (4, 250))]
    w = leaves[0][3]            # one round's weights for every leaf
    got = ops.quantized_gossip_mix_many(
        [torch.from_numpy(own) for own, *_ in leaves],
        [qs for _, qs, _, _ in leaves], [scs for _, _, scs, _ in leaves],
        w.tolist())
    assert len(got) == len(leaves)
    for (own, qs, scs, _), g in zip(leaves, got):
        jq = [_jpayload(q) for q in qs]
        js = [jnp.asarray(sc.numpy()) for sc in scs]
        want = jref.quantized_gossip_mix_ref(jnp.asarray(own), jq, js,
                                             jnp.asarray(w))
        assert g.dtype == torch.float32
        assert _same_bits(g, np.asarray(want, np.float32))
        assert _same_bits(g, ops.quantized_gossip_mix(
            torch.from_numpy(own), qs, scs, w.tolist()))
        if S:
            kern = np.asarray(quantized_gossip_mix_slots_pallas(
                jnp.asarray(own), tuple(jq), tuple(js), jnp.asarray(w),
                interpret=True))
            terms = np.abs(w[0] * own) + sum(
                np.abs(w[s + 1] * q.float().numpy() * sc.numpy())
                for s, (q, sc) in enumerate(zip(qs, scs)))
            ulps = np.abs(g.numpy().astype(np.float64) - kern) / np.spacing(
                np.maximum(terms, 1e-30).astype(np.float32))
            assert ulps.max() <= 4


def test_quantized_gossip_mix_many_takes_matching_lists():
    own, qs, scales, w = _qmix_inputs("int8", 2)
    o = torch.from_numpy(own)
    assert ops.quantized_gossip_mix_many([], [], [], w.tolist()) == []
    with pytest.raises(ValueError, match="lists"):
        ops.quantized_gossip_mix_many([o, o], [qs], [scales], w.tolist())
    with pytest.raises(ValueError):
        ops.quantized_gossip_mix_many([o], [qs[:1]], [scales[:1]],
                                      w.tolist())
    with pytest.raises(ValueError, match="one device"):
        ops.quantized_gossip_mix_many([o, o.to("meta")], [qs, qs],
                                      [scales, scales], w.tolist())


# ---------------------------------------------------------------------------
# codecs: payload bits, decode, the EF law
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_err", [False, True])
@pytest.mark.parametrize("name", J.CODEC_NAMES)
def test_codec_payload_and_decode_match_reference(name, with_err):
    cfg_kw = dict(codec=name, chunk=32, topk_frac=0.2)
    jcfg, cfg = J.CompressionConfig(**cfg_kw), T.CompressionConfig(**cfg_kw)
    x = _rows(6, 32, 1)
    x[1, 20:] = 0.0                                # ties in the tail
    x[2, :4] = x[2, 4:8]                           # equal magnitudes
    err = 0.01 * _rows(6, 32, 2) if with_err else None
    key = tref.sr_key(7, 3)
    jpay, jres = J.get_codec(name).compress(
        jcfg, jnp.asarray(x), None if err is None else jnp.asarray(err),
        jnp.uint32(key), 3, None)
    pay, res = T.get_codec(name).compress(
        cfg, torch.from_numpy(x), None if err is None
        else torch.from_numpy(err), key, 3)
    assert set(pay) == set(jpay)
    for k in jpay:
        assert _same_bits(pay[k], jpay[k]), k
    assert _same_bits(res, jres)
    hat = T.get_codec(name).decode(cfg, pay)
    assert _same_bits(hat, J.get_codec(name).decode(jcfg, jpay))
    want = x if err is None else x + err
    np.testing.assert_allclose((hat + res).numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", LOSSY)
def test_wire_bytes_match_payload_and_padding_is_lossless(name):
    P, chunk = 1000, 256
    cfg = T.CompressionConfig(codec=name, chunk=chunk)
    x = torch.from_numpy(_rows(1, P, 4).reshape(-1))
    x2d = T.flat_to_rows(x, chunk)
    codec = T.get_codec(name)
    payload, resid = codec.compress(cfg, x2d, None, tref.sr_key(0, 0), 0)
    assert sum(v.numel() * v.element_size() for v in payload.values()) \
        == cfg.wire_bytes(P)
    hat = codec.decode(cfg, payload).reshape(-1)
    assert not bool(hat[P:].any()) and not bool(resid.reshape(-1)[P:].any())


# ---------------------------------------------------------------------------
# chunk-row plumbing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,chunk", [((4, 7, 13), 32), ((3, 5), 32),
                                         ((2, 64), 32), ((3, 1152), 256),
                                         ((1, 300), 32)])
def test_leaf_rows_roundtrip_matches_reference(shape, chunk):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(J.leaf_to_rows(jnp.asarray(x), chunk))
    got = T.leaf_to_rows(torch.from_numpy(x), chunk)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(T.rows_to_leaf(got, shape).numpy(), x)
    bf = torch.from_numpy(x).to(torch.bfloat16)
    assert torch.equal(T.rows_to_leaf(T.leaf_to_rows(bf, chunk), shape),
                       bf.float())
    flat = x.reshape(-1)
    f2d = T.flat_to_rows(torch.from_numpy(flat), chunk)
    assert np.array_equal(f2d.numpy(),
                          np.asarray(J.flat_to_rows(jnp.asarray(flat),
                                                    chunk)))
    assert np.array_equal(T.rows_to_flat(f2d, flat.size).numpy(), flat)


def test_init_ef_shapes_and_gating():
    params = {"w": torch.ones(4, 3, dtype=torch.bfloat16),
              "n": torch.tensor(2)}
    ef = T.init_ef(params, T.CompressionConfig(codec="int8"))
    assert ef["w"].dtype == torch.float32 and ef["w"].shape == (4, 3)
    assert not bool(ef["w"].any()) and ef["n"] is params["n"]
    assert T.init_ef(params, None) is None
    assert T.init_ef(params, T.CompressionConfig(
        codec="int8", error_feedback=False)) is None


# ---------------------------------------------------------------------------
# compressed_dense_mix against the reference
# ---------------------------------------------------------------------------

def _tree(n, seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((n, 7, 13)).astype(np.float32),
            "b": rng.standard_normal((n, 40)).astype(np.float32),
            "e": rng.standard_normal((n, 2, 128)).astype(np.float32)}


@pytest.mark.parametrize("ef_on", [True, False])
@pytest.mark.parametrize("n,k,t", [(3, 1, 0), (5, 1, 4), (5, 2, 9)])
@pytest.mark.parametrize("name", J.CODEC_NAMES)
def test_compressed_dense_mix_matches_reference(name, n, k, t, ef_on):
    kw = dict(codec=name, chunk=32, error_feedback=ef_on)
    jcfg, cfg = J.CompressionConfig(**kw), T.CompressionConfig(**kw)
    tree = _tree(n, 10 * n + t)
    ef0 = {key: 0.05 * v for key, v in _tree(n, 99).items()} \
        if ef_on else None
    sched = jbuild(JSpec(name="base", n=n, k=k))
    W = np.asarray(sched.W(t), np.float32)
    jout, jef = J.compressed_dense_mix(
        jnp.asarray(W), jax.tree.map(jnp.asarray, tree),
        None if ef0 is None else jax.tree.map(jnp.asarray, ef0), jcfg, t)
    ef = None if ef0 is None else {key: torch.from_numpy(v.copy())
                                   for key, v in ef0.items()}
    out, ef2 = T.compressed_dense_mix(
        torch.from_numpy(W), {key: torch.from_numpy(v)
                              for key, v in tree.items()}, ef, cfg, t)
    for key in tree:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]),
                                   rtol=0, atol=1e-6)
        if ef_on:
            assert ef2[key] is ef[key]        # updated in place
            assert _same_bits(ef2[key], jef[key]), key
    assert (ef2 is None) == (jef is None)


def _stacked_tree(case, n):
    """A node-stacked reference pytree with stacked pattern blocks."""
    rng = np.random.default_rng(3)
    if case == "3-block leaf":
        # 7 x 13 = 91 and 33 values per block: no block fills whole chunks
        shapes = {"embed": {"table": (n, 40, 9)},
                  "stack": {"prologue": [{"w": (n, 5, 6)}],
                            "blocks": [{"w": (n, 3, 7, 13)},
                                       {"s": (n, 3, 33)}]}}
        return jax.tree.map(lambda sh: rng.standard_normal(sh).astype(
            np.float32), shapes, is_leaf=lambda x: isinstance(x, tuple))
    params = JM.init(jget_config("gemma3-1b").reduced(num_blocks=2),
                     jax.random.PRNGKey(2), jnp.float32)
    return jax.tree.map(lambda a: np.stack([
        np.asarray(a) + 0.01 * rng.standard_normal(a.shape).astype(
            np.float32) for _ in range(n)]), params)


@pytest.mark.parametrize("codec", ["int8", "fp8"])
@pytest.mark.parametrize("case", ["3-block leaf", "reduced gemma3-1b"])
def test_compressed_dense_mix_on_stacked_leaves_matches_reference(case,
                                                                  codec):
    """The port's flat dict (one tensor per block) against the reference
    on its own stacked tree: mixed within 1e-6, residuals bit for bit."""
    n, t = 3, 5
    kw = dict(codec=codec, chunk=32, error_feedback=True)
    jtree = _stacked_tree(case, n)
    jef = jax.tree.map(lambda a: 0.05 * np.random.default_rng(4)
                       .standard_normal(a.shape).astype(np.float32), jtree)
    W = np.asarray(jbuild(JSpec(name="base", n=n, k=1)).W(t), np.float32)
    jout, jef2 = J.compressed_dense_mix(
        jnp.asarray(W), jax.tree.map(jnp.asarray, jtree),
        jax.tree.map(jnp.asarray, jef), J.CompressionConfig(**kw), t)
    tree = tree_from_jax(jtree, node_axis=True)
    ef = tree_from_jax(jef, node_axis=True)
    out, ef2 = T.compressed_dense_mix(torch.from_numpy(W), tree, ef,
                                      T.CompressionConfig(**kw), t)
    want = tree_from_jax(jax.tree.map(np.asarray, jout), node_axis=True)
    want_ef = tree_from_jax(jax.tree.map(np.asarray, jef2), node_axis=True)
    assert list(out) == list(tree) and set(want) == set(tree)
    assert any(len(g) > 1 for g in T.reference_leaves(tree))
    for key in tree:
        np.testing.assert_allclose(out[key].numpy(), want[key].numpy(),
                                   rtol=0, atol=1e-6)
        assert ef2[key] is ef[key] and _same_bits(ef[key], want_ef[key]), key


@pytest.mark.parametrize("cap", [0, 20000, None])
@pytest.mark.parametrize("codec", ["int8", "fp8"])
def test_bucketed_compressed_dense_mix_matches_reference(monkeypatch, codec,
                                                         cap):
    """Reduced gemma3-1b, n = 3: buckets of reference leaves (one per
    leaf at cap 0, several leaves each at a 20,000-byte cap, one bucket
    at the default cap) quantized in one grouped call each; the mix
    within 1e-6 of the reference's and the residuals bit for bit, and
    every cap's results equal bit for bit."""
    n, t = 3, 2
    kw = dict(codec=codec, chunk=32, error_feedback=True)
    jtree = _stacked_tree("reduced gemma3-1b", n)
    jef = jax.tree.map(lambda a: 0.05 * np.random.default_rng(5)
                       .standard_normal(a.shape).astype(np.float32), jtree)
    W = np.asarray(jbuild(JSpec(name="base", n=n, k=1)).W(t), np.float32)
    jout, jef2 = J.compressed_dense_mix(
        jnp.asarray(W), jax.tree.map(jnp.asarray, jtree),
        jax.tree.map(jnp.asarray, jef), J.CompressionConfig(**kw), t)
    want = tree_from_jax(jax.tree.map(np.asarray, jout), node_axis=True)
    want_ef = tree_from_jax(jax.tree.map(np.asarray, jef2), node_axis=True)
    tree = tree_from_jax(jtree, node_axis=True)
    if cap is not None:
        monkeypatch.setattr(tmixing, "BUCKET_BYTES", cap)
    calls = []
    real = ops.quantize_payload_many

    def counting(xs, *args, **kw):
        calls.append(len(list(xs)))
        return real(xs, *args, **kw)

    monkeypatch.setattr(ops, "quantize_payload_many", counting)
    runs = []
    for c in (tmixing.BUCKET_BYTES, 0):
        monkeypatch.setattr(tmixing, "BUCKET_BYTES", c)
        calls.clear()
        ef = tree_from_jax(jef, node_axis=True)
        out, ef2 = T.compressed_dense_mix(torch.from_numpy(W), tree, ef,
                                          T.CompressionConfig(**kw), t)
        leaves = [g for g in T.reference_leaves(tree)]
        sizes = [tmixing.rows_bytes([tree[k] for k in g], 32)
                 for g in leaves]
        assert calls == [len(b) for b in plan_buckets(sizes, c)]
        runs.append((out, ef2))
    (out, ef2), (out0, ef0) = runs
    assert len(calls) == len(leaves) > 1
    for key in tree:
        np.testing.assert_allclose(out[key].numpy(), want[key].numpy(),
                                   rtol=0, atol=1e-6)
        assert _same_bits(ef2[key], want_ef[key]), key
        assert _same_bits(out[key], out0[key]) and _same_bits(ef2[key],
                                                              ef0[key])


def test_identity_mix_is_the_plain_mix():
    tree = {key: torch.from_numpy(v) for key, v in _tree(5, 0).items()}
    W = torch.from_numpy(np.asarray(jbuild(JSpec(name="base", n=5,
                                                 k=1)).W(0), np.float32))
    cfg = T.CompressionConfig(chunk=32)
    out, ef = T.compressed_dense_mix(W, tree, T.init_ef(tree, cfg), cfg, 0)
    plain = mix(W, tree)
    jplain = jmix(jnp.asarray(W.numpy()),
                  jax.tree.map(lambda v: jnp.asarray(v.numpy()), tree))
    for key in tree:
        torch.testing.assert_close(out[key], plain[key], rtol=0, atol=1e-6)
        np.testing.assert_allclose(plain[key].numpy(),
                                   np.asarray(jplain[key]), rtol=0,
                                   atol=1e-6)
        assert not bool(ef[key].any())


def test_mix_passes_non_float_tensors_and_is_deterministic_in_t():
    tree = {"a": torch.from_numpy(_rows(5, 64, 3)),
            "step": torch.tensor([1, 2, 3, 4, 5])}
    W = torch.from_numpy(np.asarray(jbuild(JSpec(name="base", n=5,
                                                 k=1)).W(0), np.float32))
    cfg = T.CompressionConfig(codec="int8", chunk=32, error_feedback=False)
    o1, _ = T.compressed_dense_mix(W, tree, None, cfg, 5)
    o2, _ = T.compressed_dense_mix(W, tree, None, cfg, 5)
    o3, _ = T.compressed_dense_mix(W, tree, None, cfg, 6)
    assert o1["step"] is tree["step"]
    assert torch.equal(o1["a"], o2["a"]) and not torch.equal(o1["a"],
                                                             o3["a"])
