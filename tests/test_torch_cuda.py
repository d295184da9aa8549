"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Needs a CUDA device and ``nvcc``; every test here carries the
``cuda`` marker and skips without a card.  Imports no JAX, so it runs
where the port runs:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Flash attention's tolerance, element by element: |kernel - plain| <=
1e-4 (f32 FMAs summed in another order), plus in bf16 2**-7 * |plain|,
one bf16 rounding step of the element, since the plain version rounds
its f32 result to bf16 once and the kernel once.  Its autograd Function's
gradients equal plain autograd bit for bit: the backward is the same
plain recompute.  The fused DSGD kernel equals its plain version bit for
bit: it takes the same f32 rounding steps in the same order.  So does
the quantize+EF kernel, on q, scale and the residual, in int8 and fp8,
with and without err: its payload is a bitwise contract.  The paged
flash-attention kernel is held to flash attention's tolerance against
its plain version, and to its own row contract bit for bit: a verify
window equals one-row calls, whatever else the block holds.  The dense
kernel holds the same contract (both run ``csrc/flash_core.cuh``): its
verify window equals one-row calls, its one-row call equals the paged
kernel's over pages holding the same bits, and in both kernels a call
split over the key axis equals ``kv_splits=1`` bit for bit.  K/V or pools
whose rows the kernels' 16-byte copies cannot read are copied first.  The gossip
combine (both entry points, f32 and bf16, 1 to 32 slots, aligned or
not) and the quantized combine (int8 and fp8, every fp8 code, 0 to 3
slots) equal their plain versions bit for bit: the same f32 steps in the
same order.  So do the grouped launches of the fused DSGD and combine
kernels over ragged lists (mixed dtypes, an unaligned leaf, an empty
one, a 1,152-element leaf beside a 302 M-element one, more leaves than
one table holds), one launch per dtype (pair) and table.  The
distributed mixer runs on the card in two gloo ranks (host staging) and
launches one grouped combine per bucket, or when compressed one grouped
quantize and one grouped quantized combine per bucket of reference
leaves.  The grouped quantize+EF and quantized combine kernels equal
their plain versions bit for bit over ragged lists (C = 2, 6, 128-1024,
the vector and scalar loops, unaligned buffers, row offsets whose
indices pass 2^32, zero rows, fp8's subnormal tail, every payload byte,
0 to 31 slots, more buffers than one table holds), one launch per table
and mode.  ``ops.sdpa_decode`` (the fixed-batch speculative engine's
draft steps and verify) launches the dense kernel at per-request
positions, within flash attention's tolerance of the plain
``grouped_sdpa_decode_ref``, its verify window equal to one-row calls bit
for bit; the fixed-batch engine's tokens and speculative counters on the
card are the CPU's, with the flash launches its rounds make.  Head dims
the kernel is not instantiated for (reduced MLA's (48, 32), and (64, 32))
go through ``ops.sdpa`` / ``ops.sdpa_decode`` into the kernel's wrapper,
which zero-pads them to (64, 64) and counts the launch under the
caller's pair, equal to the kernel on hand-padded inputs bit for bit; grok-1's 6 query
heads per kv head with softcap 30 hold flash attention's tolerance; and
an MoE layer at top-8 in bf16 gives the same bits on every run.
"""
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (SUPPORTED_DIMS,
                                                 flash_attention_fwd)
from repro_torch.kernels import multi_tensor as mt
from repro_torch.kernels.fused_dsgd import fused_dsgd, fused_dsgd_many
from repro_torch.kernels.gossip_mix import (gossip_mix_slots,
                                            gossip_mix_slots_many,
                                            gossip_mix_stacked)
from repro_torch.kernels.paged_flash_attention import \
    paged_flash_attention_fwd
from repro_torch.kernels.quantized_gossip import (
    MAX_MIX_SLOTS, quantize_ef, quantize_ef_many, quantized_gossip_mix,
    quantized_gossip_mix_many)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, want):
    diff = (got.float() - want.float()).abs()
    tol = 1e-4 + (2.0 ** -7 * want.float().abs()
                  if got.dtype == torch.bfloat16 else 0.0)
    assert bool((diff <= tol).all()), float((diff / tol).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,Dv", SUPPORTED_DIMS)
@pytest.mark.parametrize("H,KV,Tq,S,q0,valid,window,softcap", [
    (4, 1, 37, 60, 10, 47, None, None),   # prefill continuation, NaN tail
    (4, 2, 70, 70, 0, 70, 16, None),      # square prefill with a window
    (8, 8, 1, 90, 52, 53, 24, 30.0),      # decode with window and softcap
    (4, 1, 1, 130, 129, 130, None, None),
])
def test_kernel_matches_plain(card, dtype, D, Dv, H, KV, Tq, S, q0, valid,
                              window, softcap):
    g = torch.Generator(device=card).manual_seed(0)
    B = 2
    q = torch.randn(B, Tq, H, D, generator=g, device=card).to(dtype)
    k = torch.randn(B, S, KV, D, generator=g, device=card).to(dtype)
    v = torch.randn(B, S, KV, Dv, generator=g, device=card).to(dtype)
    k[:, valid:] = float("nan")
    v[:, valid:] = float("nan")
    kw = dict(window=window, softcap=softcap, q_pos0=q0, k_valid_len=valid)
    want = ref.grouped_sdpa_ref(q, k, v, **kw)
    before = flash_attention_fwd.launches
    got = flash_attention_fwd(q, k, v, window=window, softcap=softcap,
                              q_start=q0, k_valid_len=valid)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    _assert_close(got, want)


@pytest.mark.parametrize("causal", [True, False])
def test_kernel_reads_strided_views_and_per_batch_positions(card, causal):
    g = torch.Generator(device=card).manual_seed(1)
    B, H, KV, Tq, S, D = 3, 4, 1, 2, 40, 128
    q = torch.randn(B, H, Tq, D, generator=g, device=card).transpose(1, 2)
    k = torch.randn(B, KV, S, D, generator=g, device=card).transpose(1, 2)
    v = torch.randn(B, KV, S, D, generator=g, device=card).transpose(1, 2)
    starts = torch.tensor([0, 7, 38], device=card, dtype=torch.int32)
    valid = starts + Tq
    want = ref.grouped_sdpa_ref(q, k, v, causal=causal, window=8,
                                q_pos0=starts, k_valid_len=valid)
    got = flash_attention_fwd(q, k, v, causal=causal, window=8,
                              q_start=starts, k_valid_len=valid)
    torch.cuda.synchronize()
    _assert_close(got, want)


def test_kernels_copy_views_their_16_byte_copies_cannot_read(card):
    """K/V (and pools) that start 4 bytes off 16-byte alignment: the
    wrappers copy them, and the results match the plain versions."""
    g = torch.Generator(device=card).manual_seed(7)
    B, H, KV, Tq, S, D, ps = 2, 4, 1, 3, 48, 64, 16

    def off(*shape):
        n = 1
        for d in shape:
            n *= d
        return torch.randn(n + 1, generator=g, device=card)[1:].view(shape)

    q = torch.randn(B, Tq, H, D, generator=g, device=card)
    k, v = off(B, S, KV, D), off(B, S, KV, D)
    _assert_close(flash_attention_fwd(q, k, v),
                  ref.grouped_sdpa_ref(q, k, v))
    kp, vp = off(B * S // ps + 1, ps, KV, D), off(B * S // ps + 1, ps, KV, D)
    table = torch.arange(1, B * S // ps + 1, dtype=torch.int32,
                         device=card).view(B, S // ps)
    kw = dict(q_start=S - Tq, k_valid_len=S)
    _assert_close(paged_flash_attention_fwd(q, kp, vp, table, **kw),
                  ref.paged_sdpa_ref(q, kp, vp, table, **kw))
    torch.cuda.synchronize()


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pre_mode", ["one", "scalar", "row"])
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 1152), (257, 513),
                                   (3, 4, 65), (70000, 3)])
def test_fused_dsgd_matches_plain_bitwise(card, dtype, pre_mode, shape):
    g = torch.Generator(device=card).manual_seed(2)
    x, u, gr = (torch.randn(shape, generator=g, device=card).to(dtype)
                for _ in range(3))
    pre = {"one": 1.0, "scalar": 0.37}.get(pre_mode)
    if pre is None:
        pre = torch.rand(shape[0], generator=g, device=card) + 0.2
    before = fused_dsgd.launches
    got = ops.fused_dsgd_step(x, u, gr, 0.9, 0.01, pre)
    torch.cuda.synchronize()
    assert fused_dsgd.launches == before + 1
    bp = pre.reshape((-1,) + (1,) * (len(shape) - 1)) \
        if isinstance(pre, torch.Tensor) else pre
    want = ref.fused_dsgd_ref(x, u, gr, 0.9, 0.01, bp)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))


def _unaligned(shape, dtype, g, card):
    """A contiguous tensor one element past its storage's start: 2 or 4
    bytes off 16-byte alignment."""
    n = 1
    for d in shape:
        n *= d
    return torch.randn(n + 1, generator=g, device=card).to(dtype)[1:].view(
        shape)


def _dsgd_leaves(card, specs, seed):
    """(x, u, g) lists from ``(shape, dtype, unaligned)`` specs."""
    g = torch.Generator(device=card).manual_seed(seed)
    xs, us, gs = [], [], []
    for shape, dtype, off in specs:
        make = (lambda: _unaligned(shape, dtype, g, card)) if off else (
            lambda: torch.randn(shape, generator=g, device=card).to(dtype))
        xs.append(make())
        us.append(make())
        gs.append(make())
    return xs, us, gs


def _check_dsgd_many(xs, us, gs, pre):
    want_launches = len({x.dtype for x in xs if x.numel()})
    before = (fused_dsgd_many.launches, fused_dsgd_many.segments)
    got_x, got_u = ops.fused_dsgd_steps(xs, us, gs, 0.9, 0.01, pre)
    torch.cuda.synchronize()
    assert fused_dsgd_many.launches - before[0] >= want_launches
    assert fused_dsgd_many.segments - before[1] == sum(
        1 for x in xs if x.numel())
    for x, u, gr, gx, gu in zip(xs, us, gs, got_x, got_u):
        bp = pre.reshape((-1,) + (1,) * (x.ndim - 1)) \
            if isinstance(pre, torch.Tensor) else pre
        wx, wu = ref.fused_dsgd_ref(x, u, gr, 0.9, 0.01, bp)
        for a, b in ((gx, wx), (gu, wu)):
            assert a.dtype == x.dtype and a.shape == x.shape
            assert torch.equal(_bits(a), _bits(b))


RAGGED = [((3, 1), torch.float32, False), ((3, 1152), torch.bfloat16, False),
          ((3, 7, 5), torch.bfloat16, False), ((3, 0), torch.float32, False),
          ((3, 257, 3), torch.float32, True), ((3, 1000), torch.bfloat16,
                                               True),
          ((3, 4, 65), torch.float32, False), ((3, 70001), torch.bfloat16,
                                               False)]


@pytest.mark.parametrize("pre_mode", ["one", "scalar", "row"])
def test_fused_dsgd_many_ragged_list_matches_plain_bitwise(card, pre_mode):
    xs, us, gs = _dsgd_leaves(card, RAGGED, 3)
    pre = {"one": 1.0, "scalar": 0.37}.get(pre_mode)
    if pre is None:
        pre = torch.rand(3, device=card) + 0.2
    before = fused_dsgd_many.launches
    _check_dsgd_many(xs, us, gs, pre)
    assert fused_dsgd_many.launches == before + 2    # f32 and bf16


def test_fused_dsgd_many_small_leaf_beside_an_embedding(card):
    """A norm scale beside gemma3-1b's embedding (302 M elements), bf16,
    one launch, per-row pre."""
    xs, us, gs = _dsgd_leaves(card, [((1, 1152), torch.bfloat16, False),
                                     ((1, 262144 * 1152), torch.bfloat16,
                                      False)], 4)
    before = fused_dsgd_many.launches
    _check_dsgd_many(xs, us, gs, torch.tensor([0.7], device=card))
    assert fused_dsgd_many.launches == before + 1


def test_fused_dsgd_many_splits_a_list_past_one_table(card):
    n = mt.capacity(5) * 2 + 3
    xs, us, gs = _dsgd_leaves(card, [((2, 9 + i % 5), torch.float32, False)
                                     for i in range(n)], 5)
    before = fused_dsgd_many.launches
    _check_dsgd_many(xs, us, gs, torch.tensor([0.5, 0.9], device=card))
    assert fused_dsgd_many.launches == before + 3


def _mix_lists(card, specs, S, seed):
    """S slot buffers per ``(shape, dtype, unaligned)`` spec, the last slot
    zeros at weight 0."""
    g = torch.Generator(device=card).manual_seed(seed)
    lists = []
    for shape, dtype, off in specs:
        bufs = [_unaligned(shape, dtype, g, card) if off else
                torch.randn(shape, generator=g, device=card).to(dtype)
                for _ in range(S)]
        if S > 1:
            bufs[-1].zero_()
        lists.append(bufs)
    w = (torch.rand(S, generator=g, device=card) + 0.1).tolist()
    if S > 1:
        w[-1] = 0.0
    return lists, w


def _check_mix_many(lists, w, out_dtype):
    before = (gossip_mix_slots_many.launches, gossip_mix_slots_many.segments)
    got = ops.gossip_mix_many(lists, w, out_dtype)
    torch.cuda.synchronize()
    outs = ([out_dtype] * len(lists) if not isinstance(out_dtype, list)
            else out_dtype)
    pairs = {(b[0].dtype, d or b[0].dtype) for b, d in zip(lists, outs)
             if b[0].numel()}
    assert gossip_mix_slots_many.launches - before[0] == len(pairs)
    assert gossip_mix_slots_many.segments - before[1] == sum(
        1 for b in lists if b[0].numel())
    for bufs, d, o in zip(lists, outs, got):
        want = ref.gossip_mix_ref(bufs, w, out_dtype=d)
        assert o.dtype == want.dtype and o.shape == bufs[0].shape
        assert torch.equal(_bits(o), _bits(want))


@pytest.mark.parametrize("out", ["own", "float32", "bfloat16", "mixed"])
@pytest.mark.parametrize("S", [1, 2, 3, 32])
def test_gossip_mix_many_ragged_list_matches_plain_bitwise(card, S, out):
    lists, w = _mix_lists(card, RAGGED, S, S)
    out_dtype = {"own": None, "float32": torch.float32,
                 "bfloat16": torch.bfloat16,
                 "mixed": [torch.bfloat16, torch.float32] * 4}[out]
    _check_mix_many(lists, w, out_dtype)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_gossip_mix_many_small_tensor_beside_an_embedding(card, out_dtype):
    """One rank's f32 work buffers of a norm scale and of gemma3-1b's
    embedding, own + one received: one launch."""
    lists, w = _mix_lists(card, [((1, 1152), torch.float32, False),
                                 ((1, 262144, 1152), torch.float32, False)],
                          2, 9)
    _check_mix_many(lists, w, out_dtype)


def test_grouped_entry_points_reject_mixed_lists(card):
    x = torch.randn(4, 32, device=card)
    with pytest.raises(ValueError, match="one device"):
        ops.fused_dsgd_steps([x, x.cpu()], [x, x.cpu()], [x, x.cpu()], 0.9,
                             0.01)
    with pytest.raises(ValueError, match="one device"):
        ops.gossip_mix_many([[x, x], [x.cpu(), x.cpu()]], [0.5, 0.5])
    with pytest.raises(ValueError, match="shape"):
        ops.gossip_mix_many([[x, x[:2]]], [0.5, 0.5])
    with pytest.raises(ValueError, match="slots"):
        ops.gossip_mix_many([[x, x], [x]], [0.5, 0.5])
    with pytest.raises(ValueError, match="first axis"):
        ops.fused_dsgd_steps([x, x[0]], [x, x[0]], [x, x[0]], 0.9, 0.01,
                             torch.ones(4, device=card))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 16])
def test_flash_autograd_gradients_equal_plain_autograd(card, dtype, window):
    g = torch.Generator(device=card).manual_seed(3)
    B, T, H, KV, D = 2, 70, 4, 1, 64
    leaves = [torch.randn(B, T, h, D, generator=g, device=card).to(dtype)
              for h in (H, KV, KV)]
    go = torch.randn(B, T, H, D, generator=g, device=card).to(dtype)
    grads = []
    for fn in (ops.sdpa, ref.grouped_sdpa_ref):
        q, k, v = (t.clone().requires_grad_() for t in leaves)
        before = flash_attention_fwd.launches
        out = fn(q, k, v, window=window, q_pos0=0)
        assert flash_attention_fwd.launches == before + (fn is ops.sdpa)
        grads.append(torch.autograd.grad(out, (q, k, v), go))
    torch.cuda.synchronize()
    for a, b in zip(*grads):
        assert a.dtype == dtype and torch.equal(_bits(a), _bits(b))


def _quant_case(card, R, C, seed, case):
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn(R, C, generator=g, device=card)
    err = 0.1 * torch.randn(R, C, generator=g, device=card)
    if case == "zero-rows":
        x[::3] = 0.0
        err[::3] = 0.0
    elif case == "subnormal":
        # |s| < amax * 2^-6 / 448: e4m3's subnormal range after scaling
        x[:, 0] = 3.0
        x[:, 1:] *= 1e-5
        err.zero_()
    return x, err


@pytest.mark.parametrize("with_err", [False, True])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("R,C,off,case", [
    (15, 256, 0, None), (1001, 256, 7, None), (13, 2, 0, None),
    (9, 32, 0, None), (21, 250, 3, None), (24, 64, 0, "zero-rows"),
    (40, 256, 0, "subnormal"),
    (64, 256, (1 << 23) - 32, None),     # index crosses 2^31
    (64, 256, (1 << 24) - 32, None),     # index crosses 2^32
])
def test_quantize_ef_matches_plain_bitwise(card, fmt, with_err, R, C, off,
                                           case):
    x, err = _quant_case(card, R, C, R * C, case)
    if not with_err:
        err = None
    before = quantize_ef.launches
    got = ops.quantize_payload(x, err, fmt=fmt, key=ref.sr_key(3, 9),
                               row_offset=off)
    torch.cuda.synchronize()
    assert quantize_ef.launches == before + 1
    want = ref.quantize_ef_ref(x, err, ref.sr_key(3, 9), off, fmt=fmt)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_quantize_ef_rejects_what_it_does_not_take(card):
    x = torch.randn(4, 32, device=card)
    with pytest.raises(TypeError, match="float32"):
        quantize_ef(x.to(torch.bfloat16), None, 1, fmt="int8")
    with pytest.raises(ValueError, match="shape"):
        quantize_ef(x, torch.randn(4, 16, device=card), 1, fmt="int8")
    with pytest.raises(ValueError, match="C >= 2"):
        quantize_ef(x[:, :1].contiguous(), None, 1, fmt="int8")
    with pytest.raises(ValueError, match="shape"):
        quantize_ef(x.reshape(2, 2, 32), None, 1, fmt="int8")
    with pytest.raises(ValueError, match="contiguous"):
        quantize_ef(x.t(), None, 1, fmt="fp8")
    with pytest.raises(ValueError, match="CUDA"):
        quantize_ef(x, x.cpu(), 1, fmt="fp8")
    with pytest.raises(ValueError, match="fmt"):
        quantize_ef(x, None, 1, fmt="int4")


# (R, C, row_offset, case, unaligned) per buffer: the vector loop (C =
# 256, aligned) and the scalar loop (C = 2, 6, 1024, 250; unaligned
# starts), row offsets whose indices cross 2^31 and 2^32 and pass 2^32
# many times, zero rows and fp8's subnormal tail
QUANT_RAGGED = [
    (15, 256, 0, None, False), (7, 2, 3, None, False), (5, 6, 0, None, True),
    (33, 256, 11, None, True), (9, 1024, 0, None, False),
    (21, 250, 3, None, False), (24, 256, 0, "zero-rows", False),
    (40, 256, 0, "subnormal", False),
    (64, 256, (1 << 23) - 32, None, False),       # indices cross 2^31
    (64, 256, (1 << 24) - 32, None, False),       # and 2^32
    (17, 256, 5 * (1 << 24) + 3, None, False),    # past 2^32, five times
    (3, 1024, (1 << 22) - 1, None, True)]


def _quant_list(card, specs, seed):
    xs, errs, offs = [], [], []
    for i, (R, C, off, case, unaligned) in enumerate(specs):
        x, err = _quant_case(card, R, C, seed + i, case)
        if unaligned:       # one f32 past a 16-byte boundary
            x = _unaligned((R, C), torch.float32, torch.Generator(
                device=card).manual_seed(i), card).copy_(x)
            err = _unaligned((R, C), torch.float32, torch.Generator(
                device=card).manual_seed(i), card).copy_(err)
        xs.append(x)
        errs.append(err)
        offs.append(off)
    return xs, errs, offs


def _check_quantize_many(xs, errs, offs, fmt, key, launches):
    before = (quantize_ef_many.launches, quantize_ef_many.segments)
    got = ops.quantize_payload_many(xs, errs, fmt=fmt, key=key,
                                    row_offsets=offs)
    torch.cuda.synchronize()
    assert quantize_ef_many.launches == before[0] + launches
    assert quantize_ef_many.segments == before[1] + sum(
        1 for x in xs if x.numel())
    errs = errs if errs is not None else [None] * len(xs)
    for x, e, off, *outs in zip(xs, errs, offs, *got):
        want = ref.quantize_ef_ref(x, e, key, off, fmt=fmt)
        for a, b in zip(outs, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("with_err", [False, True])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantize_ef_many_ragged_list_matches_plain_bitwise(card, fmt,
                                                            with_err):
    xs, errs, offs = _quant_list(card, QUANT_RAGGED, 20)
    _check_quantize_many(xs, errs if with_err else None, offs, fmt,
                         ref.sr_key(5, 2), 1)


def test_quantize_ef_many_mixed_err_launches_once_per_mode(card):
    xs, errs, offs = _quant_list(card, QUANT_RAGGED[:6], 30)
    errs[1] = errs[4] = None
    _check_quantize_many(xs, errs, offs, "int8", 77, 2)


def test_quantize_ef_many_splits_a_list_past_one_table(card):
    n = mt.capacity(5, mt.ROW_META_WORDS) * 2 + 3
    specs = [(1 + i % 4, 256 if i % 3 else 6, 4 * i, None, False)
             for i in range(n)]
    xs, errs, offs = _quant_list(card, specs, 40)
    _check_quantize_many(xs, errs, offs, "fp8", 9, 3)


def test_quantize_ef_many_on_gemma3_1b_norm_and_gate_rows(card):
    """A norm scale's and an MLP gate's chunk rows of one rank (1 and
    124,416 rows of 256) beside each other, rank 1's row offsets."""
    xs, errs, offs = _quant_list(card, [(18, 256, 18, None, False),
                                        (124416, 256, 124416, None, False)],
                                 50)
    _check_quantize_many(xs, errs, offs, "int8", ref.sr_key(0, 3), 1)


def test_quantize_ef_many_rejects_what_it_does_not_take(card):
    x = torch.randn(4, 32, device=card)
    with pytest.raises(TypeError, match="float32"):
        quantize_ef_many([x, x.double()], None, 1, [0, 0], fmt="int8")
    with pytest.raises(ValueError, match="shape"):
        quantize_ef_many([x, x], [x, x[:, :16].contiguous()], 1, [0, 0],
                         fmt="int8")
    with pytest.raises(ValueError, match="one device"):
        quantize_ef_many([x, x.cpu()], None, 1, [0, 0], fmt="int8")
    with pytest.raises(ValueError, match="row offsets"):
        quantize_ef_many([x, x], None, 1, [0], fmt="int8")
    with pytest.raises(ValueError, match="contiguous"):
        quantize_ef_many([x, x.t()], None, 1, [0, 0], fmt="fp8")
    with pytest.raises(ValueError, match="fmt"):
        quantize_ef_many([x], None, 1, [0], fmt="int4")
    assert quantize_ef_many([], None, 1, [], fmt="int8") == ([], [], [])


def _qmix_list(card, fmt, S, specs, seed):
    """Per ``(R, C, unaligned)`` spec: own, S payloads (every byte value
    in the first buffer's first slot, the last slot zeros at weight 0)
    and their scales; and the round's S + 1 weights."""
    g = torch.Generator(device=card).manual_seed(seed)
    owns, q_lists, s_lists = [], [], []
    for i, (R, C, unaligned) in enumerate(specs):
        own, qs, scales, _ = _qmix_case(card, fmt, S, R, C, seed + i)
        if i:           # the byte sweep once is enough
            qs = [ref.quantize_ef_ref(torch.randn(R, C, generator=g,
                                                  device=card), None, i + s,
                                      0, fmt=fmt)[0]
                  if not (S > 1 and s == S - 1) else q
                  for s, q in enumerate(qs)]
        if unaligned:
            own = _unaligned((R, C), torch.float32, g, card).copy_(own)
            qs = [torch.empty(R * C + 1, dtype=torch.uint8, device=card)[1:]
                  .view(q.dtype).view(R, C).copy_(q) for q in qs]
        owns.append(own)
        q_lists.append(qs)
        s_lists.append(scales)
    w = (torch.rand(S + 1, generator=g, device=card) + 0.1).tolist()
    if S > 1:
        w[-1] = 0.0
    return owns, q_lists, s_lists, w


def _check_qmix_many(owns, q_lists, s_lists, w, launches):
    before = (quantized_gossip_mix_many.launches,
              quantized_gossip_mix_many.segments)
    got = ops.quantized_gossip_mix_many(owns, q_lists, s_lists, w)
    torch.cuda.synchronize()
    assert quantized_gossip_mix_many.launches == before[0] + launches
    assert quantized_gossip_mix_many.segments == before[1] + sum(
        1 for o in owns if o.numel())
    for own, qs, scs, o in zip(owns, q_lists, s_lists, got):
        want = ref.quantized_gossip_mix_ref(own, qs, scs, w)
        assert o.dtype == torch.float32 and o.shape == want.shape
        nan = torch.isnan(want)     # fp8's two NaN codes decode to NaN
        assert torch.equal(torch.isnan(o), nan)
        assert torch.equal(_bits(o)[~nan], _bits(want)[~nan])


# (R, C, unaligned): the vector loop (C a multiple of 128, aligned: one,
# two and three 128-column spans, 1024) and the scalar loop (C = 2, 6,
# 250, unaligned starts)
QMIX_RAGGED = [(37, 256, False), (5, 2, False), (4, 6, True),
               (9, 128, False), (11, 384, False), (6, 1024, False),
               (3, 250, False), (13, 256, True), (1, 256, False)]


@pytest.mark.parametrize("S", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantized_gossip_mix_many_ragged_list_matches_plain_bitwise(
        card, fmt, S):
    owns, q_lists, s_lists, w = _qmix_list(card, fmt, S, QMIX_RAGGED, S)
    _check_qmix_many(owns, q_lists, s_lists, w, 1)


def test_quantized_gossip_mix_many_takes_the_most_slots(card):
    owns, q_lists, s_lists, w = _qmix_list(card, "fp8", MAX_MIX_SLOTS,
                                           QMIX_RAGGED[:3], 8)
    _check_qmix_many(owns, q_lists, s_lists, w, 1)


def test_quantized_gossip_mix_many_splits_a_list_past_one_table(card):
    n = mt.capacity(4, mt.ROW_META_WORDS) * 2 + 1
    owns, q_lists, s_lists, w = _qmix_list(
        card, "int8", 1, [(1 + i % 3, 256 if i % 2 else 6, False)
                          for i in range(n)], 3)
    _check_qmix_many(owns, q_lists, s_lists, w, 3)


def test_quantized_gossip_mix_many_rejects_what_it_does_not_take(card):
    own, qs, scales, w = _qmix_case(card, "int8", 2)
    with pytest.raises(ValueError, match="payloads"):
        quantized_gossip_mix_many([own, own], [qs, qs[:1]],
                                  [scales, scales[:1]], w)
    with pytest.raises(ValueError, match="lists"):
        quantized_gossip_mix_many([own, own], [qs], [scales], w)
    with pytest.raises(TypeError, match="float32"):
        quantized_gossip_mix_many([own, own.to(torch.bfloat16)], [qs, qs],
                                  [scales, scales], w)
    with pytest.raises(ValueError, match="shape"):
        quantized_gossip_mix_many([own, own[:3].contiguous()], [qs, qs],
                                  [scales, scales], w)
    with pytest.raises(ValueError, match="one device"):
        quantized_gossip_mix_many([own, own.cpu()], [qs, qs],
                                  [scales, scales], w)
    with pytest.raises(ValueError, match="0 to 31"):
        quantized_gossip_mix_many([own], [qs * 16], [scales * 16],
                                  [0.1] * 33)
    assert quantized_gossip_mix_many([], [], [], w) == []


def test_compressed_mix_on_the_card_launches_once_per_tensor(card):
    from repro_torch.compress import CompressionConfig, compressed_dense_mix
    g = torch.Generator(device=card).manual_seed(4)
    tree = {"a": torch.randn(3, 5, 70, generator=g, device=card),
            "b": torch.randn(3, 300, generator=g,
                             device=card).to(torch.bfloat16)}
    W = torch.tensor([[0.5, 0.5, 0.0], [0.5, 0.25, 0.25],
                      [0.0, 0.25, 0.75]], device=card)
    cfg = CompressionConfig(codec="int8", chunk=64)
    ef = {k: torch.zeros_like(v, dtype=torch.float32)
          for k, v in tree.items()}
    ef_cpu = {k: v.cpu() for k, v in ef.items()}
    before = (quantize_ef_many.launches, quantize_ef_many.segments)
    out, _ = compressed_dense_mix(W, tree, ef, cfg, 3)
    torch.cuda.synchronize()
    # both tensors in one bucket: one grouped launch over two segments
    assert (quantize_ef_many.launches, quantize_ef_many.segments) \
        == (before[0] + 1, before[1] + 2)
    want, _ = compressed_dense_mix(W.cpu(), {k: v.cpu()
                                             for k, v in tree.items()},
                                   ef_cpu, cfg, 3)
    for k in tree:
        assert torch.equal(ef[k].cpu().view(torch.int32),
                           ef_cpu[k].view(torch.int32))
        diff = (out[k].float().cpu() - want[k].float()).abs()
        assert out[k].dtype == tree[k].dtype
        tol = 1e-6 + (2.0 ** -7 * want[k].float().abs()
                      if out[k].dtype == torch.bfloat16 else 0.0)
        assert bool((diff <= tol).all())


def test_compressed_mix_on_the_card_launches_once_per_reference_leaf(card):
    """The blocks of one stacked reference leaf are quantized as one
    segment, with the CPU's payload: one grouped launch over the two
    reference leaves of the bucket."""
    from repro_torch.compress import CompressionConfig, compressed_dense_mix
    g = torch.Generator(device=card).manual_seed(5)
    tree = {f"stack.blocks.{b}.0.w": torch.randn(3, 7, 13, generator=g,
                                                 device=card)
            for b in range(3)}
    tree["embed.table"] = torch.randn(3, 40, generator=g, device=card)
    W = torch.full((3, 3), 1.0 / 3, device=card)
    cfg = CompressionConfig(codec="fp8", chunk=32)
    ef = {k: torch.zeros_like(v) for k, v in tree.items()}
    ef_cpu = {k: v.cpu() for k, v in ef.items()}
    before = (quantize_ef_many.launches, quantize_ef_many.segments)
    compressed_dense_mix(W, tree, ef, cfg, 1)
    torch.cuda.synchronize()
    assert (quantize_ef_many.launches, quantize_ef_many.segments) \
        == (before[0] + 1, before[1] + 2)
    compressed_dense_mix(W.cpu(), {k: v.cpu() for k, v in tree.items()},
                         ef_cpu, cfg, 1)
    for k in tree:
        assert torch.equal(ef[k].cpu().view(torch.int32),
                           ef_cpu[k].view(torch.int32))


def _mix_slots(card, dtype, S, shape, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    bufs = [torch.randn(shape, generator=g, device=card).to(dtype)
            for _ in range(S)]
    w = (torch.rand(S, generator=g, device=card) + 0.1).tolist()
    if S > 1:           # a slot this node receives nothing in
        bufs[-1].zero_()
        w[-1] = 0.0
    return bufs, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 2, 3, 9, 32])
@pytest.mark.parametrize("shape", [(1,), (3, 1152), (257, 513), (2, 3, 4)])
def test_gossip_mix_matches_plain_bitwise(card, dtype, S, shape):
    bufs, w = _mix_slots(card, dtype, S, shape, S)
    want = ref.gossip_mix_ref(bufs, w)
    before = (gossip_mix_slots.launches, gossip_mix_stacked.launches)
    got_slots = ops.gossip_mix(bufs, w)
    got_stack = ops.gossip_mix(torch.stack(bufs), w)
    torch.cuda.synchronize()
    assert (gossip_mix_slots.launches, gossip_mix_stacked.launches) \
        == (before[0] + 1, before[1] + 1)
    for got in (got_slots, got_stack):
        assert got.dtype == dtype and got.shape == want.shape
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gossip_mix_unaligned_slots_take_the_scalar_loop(card, dtype):
    bufs, w = _mix_slots(card, dtype, 3, (4, 1001), 7)
    # views one element into their storage: not 16-byte aligned
    flat = [b.reshape(-1)[1:4001].reshape(4, 1000) for b in bufs]
    got = gossip_mix_slots(flat, w)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(ref.gossip_mix_ref(flat, w)))


def test_gossip_mix_rejects_what_it_does_not_take(card):
    x = torch.randn(4, 32, device=card)
    with pytest.raises(ValueError, match="1 to 32"):
        gossip_mix_slots([x] * 33, [0.1] * 33)
    with pytest.raises(ValueError, match="weights"):
        gossip_mix_slots([x, x], [1.0])
    with pytest.raises(TypeError, match="dtype"):
        gossip_mix_slots([x, x.to(torch.bfloat16)], [0.5, 0.5])
    with pytest.raises(TypeError, match="dtype"):
        gossip_mix_slots([x.half()], [1.0])
    with pytest.raises(ValueError, match="shape"):
        gossip_mix_slots([x, x[:2]], [0.5, 0.5])
    with pytest.raises(ValueError, match="contiguous"):
        gossip_mix_slots([x.t(), x.t()], [0.5, 0.5])
    with pytest.raises(ValueError, match="CUDA"):
        gossip_mix_slots([x, x.cpu()], [0.5, 0.5])
    with pytest.raises(ValueError, match="stack"):
        gossip_mix_stacked(x, [0.5])


def _qmix_case(card, fmt, S, R=37, C=256, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    own = torch.randn(R, C, generator=g, device=card)
    qs, scales = [], []
    for s in range(S):
        x = torch.randn(R, C, generator=g, device=card)
        q, sc, _ = ref.quantize_ef_ref(x, None, ref.sr_key(2, s), 0, fmt=fmt)
        if s == 0:      # every byte value (as many as fit) in the first rows
            n = min(q.numel(), 256)
            q.view(torch.uint8).reshape(-1)[:n] = torch.arange(
                n, device=card, dtype=torch.uint8)
        if S > 1 and s == S - 1:
            q, sc = torch.zeros_like(q), torch.zeros_like(sc)
        qs.append(q)
        scales.append(sc)
    w = (torch.rand(S + 1, generator=g, device=card) + 0.1).tolist()
    if S > 1:
        w[-1] = 0.0
    return own, qs, scales, w


@pytest.mark.parametrize("S", [0, 1, 2, 3])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("R,C", [(37, 256), (5, 2), (3, 250)])
def test_quantized_gossip_mix_matches_plain_bitwise(card, fmt, S, R, C):
    own, qs, scales, w = _qmix_case(card, fmt, S, R, C, seed=S)
    before = quantized_gossip_mix.launches
    got = ops.quantized_gossip_mix(own, qs, scales, w)
    torch.cuda.synchronize()
    assert quantized_gossip_mix.launches == before + 1
    want = ref.quantized_gossip_mix_ref(own, qs, scales, w)
    assert got.dtype == torch.float32 and got.shape == want.shape
    nan = torch.isnan(want)         # fp8's two NaN codes decode to NaN
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(_bits(got)[~nan], _bits(want)[~nan])


def test_quantized_gossip_mix_rejects_what_it_does_not_take(card):
    own, qs, scales, w = _qmix_case(card, "int8", 2)
    with pytest.raises(ValueError, match="weights"):
        quantized_gossip_mix(own, qs, scales, w[:2])
    with pytest.raises(ValueError, match="scale"):
        quantized_gossip_mix(own, qs, scales[:1], w)
    with pytest.raises(TypeError, match="float32"):
        quantized_gossip_mix(own.to(torch.bfloat16), qs, scales, w)
    with pytest.raises(TypeError, match="int8"):
        quantized_gossip_mix(own, [qs[0], qs[1].view(
            torch.float8_e4m3fn)], scales, w)
    with pytest.raises(ValueError, match="shape"):
        quantized_gossip_mix(own, [q[:3] for q in qs], scales, w)
    with pytest.raises(ValueError, match="CUDA"):
        quantized_gossip_mix(own, [qs[0].cpu(), qs[1]], scales, w)


def test_dist_mixer_on_the_card_launches_once_per_tensor(card):
    """Two gloo ranks share the card (host staging): the mixer's rounds
    equal W(r) X, with one grouped slots-combine for the bucket that
    holds the three float tensors (no per-tensor combine), and the int8
    mixer's one grouped quantize and one grouped quantized combine for
    the bucket that holds its two reference leaves."""
    import numpy as np
    import torch_dist_ranks
    from repro_torch.launch.distributed import spawn_local
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((2, 4, 600)).astype(np.float32),
            "stack.blocks.0.0.w": rng.standard_normal((2, 300)).astype(
                np.float32),
            "stack.blocks.1.0.w": rng.standard_normal((2, 300)).astype(
                np.float32)}
    results = spawn_local(torch_dist_ranks.card_mixer, 2, args=(tree,),
                          backend="gloo", device="cuda", timeout=300)
    for rank, res in enumerate(results):
        assert res["device"].startswith("cuda")
        assert res["launches"] == {"gossip_mix_slots": 0,
                                   "gossip_mix_slots_many": 1,
                                   "quantize_ef": 0,
                                   "quantized_gossip_mix": 0,
                                   "quantize_ef_many": 1,
                                   "quantized_gossip_mix_many": 1}
        for key, x in tree.items():     # W(0) of Base-2 at n = 2: averaging
            np.testing.assert_allclose(res["mixed"][key][0], x.mean(axis=0),
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(res["compressed"][key][0],
                                       x.mean(axis=0), rtol=0, atol=0.05)


def _paged_case(card, dtype, *, B, H, KV, D, Dv, ps, maxp, seed):
    """q rows for a verify window of 5, pools of distinct pages per slot,
    NaN in scratch page 0 and in every page no table row names."""
    g = torch.Generator(device=card).manual_seed(seed)
    P = B * maxp + 3
    q = torch.randn(B, 5, H, D, generator=g, device=card).to(dtype)
    kp = torch.randn(P, ps, KV, D, generator=g, device=card).to(dtype)
    vp = torch.randn(P, ps, KV, Dv, generator=g, device=card).to(dtype)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(
        seed))[:B * maxp] + 1
    table = perm.reshape(B, maxp).to(torch.int32).to(card)
    unused = torch.ones(P, dtype=torch.bool)
    unused[perm] = False
    kp[unused.to(card)] = float("nan")
    vp[unused.to(card)] = float("nan")
    return q, kp, vp, table


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,Dv", SUPPORTED_DIMS)
@pytest.mark.parametrize("ps", [8, 16, 32, 64])
def test_paged_kernel_matches_plain(card, dtype, D, Dv, ps):
    """Ragged slots (a fresh slot, a page boundary, a long local window)
    with NaN in page 0 and unused pages; a window and a softcap case."""
    B, H, KV = 3, 4, 1
    maxp = -(-300 // ps)
    q, kp, vp, table = _paged_case(card, dtype, B=B, H=H, KV=KV, D=D, Dv=Dv,
                                   ps=ps, maxp=maxp, seed=ps + D)
    table[2, maxp // 2:] = 0          # entries past k_valid: scratch page
    q_start = torch.tensor([0, ps - 2, 120], device=card, dtype=torch.int32)
    k_valid = q_start + 5
    for kw in (dict(), dict(window=37), dict(softcap=30.0, window=100)):
        want = ref.paged_sdpa_ref(q, kp, vp, table, q_start=q_start,
                                  k_valid_len=k_valid, **kw)
        before = paged_flash_attention_fwd.launches
        got = ops.paged_sdpa(q, kp, vp, table, q_start=q_start,
                             k_valid_len=k_valid, **kw)
        torch.cuda.synchronize()
        assert paged_flash_attention_fwd.launches == before + 1
        assert got.dtype == dtype and got.shape == (B, 5, H, Dv)
        assert not bool(got.isnan().any())
        _assert_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,window", [(4, 1, None), (4, 1, 9),
                                         (8, 2, 40), (4, 4, None)])
def test_paged_kernel_verify_window_equals_one_row_calls(card, dtype, H, KV,
                                                         window):
    """The kernel's row contract, bit for bit: one (k+1)-row verify call
    equals k+1 one-row calls, whatever the block's other rows."""
    q, kp, vp, table = _paged_case(card, dtype, B=3, H=H, KV=KV, D=128,
                                   Dv=128, ps=16, maxp=12, seed=H + KV)
    q_start = torch.tensor([0, 31, 170], device=card, dtype=torch.int32)
    verify = paged_flash_attention_fwd(q, kp, vp, table, q_start=q_start,
                                       k_valid_len=q_start + 5,
                                       window=window)
    for i in range(5):
        one = paged_flash_attention_fwd(q[:, i:i + 1], kp, vp, table,
                                        q_start=q_start + i,
                                        k_valid_len=q_start + i + 1,
                                        window=window)
        assert torch.equal(_bits(verify[:, i:i + 1]), _bits(one)), i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,window", [(4, 1, None), (4, 1, 9),
                                         (4, 1, 40), (8, 2, 40)])
def test_dense_kernel_verify_window_equals_one_row_calls(card, dtype, H, KV,
                                                         window):
    """The dense kernel holds the row contract too: a 5-row verify call
    with per-batch q_start equals 5 one-row calls bit for bit (the
    reference's ``tests/test_decode_attention.py:80-94``)."""
    g = torch.Generator(device=card).manual_seed(H + KV + (window or 0))
    B, S, D = 3, 260, 256
    q = torch.randn(B, 5, H, D, generator=g, device=card).to(dtype)
    k = torch.randn(B, S, KV, D, generator=g, device=card).to(dtype)
    v = torch.randn(B, S, KV, D, generator=g, device=card).to(dtype)
    q_start = torch.tensor([0, 31, 170], device=card, dtype=torch.int32)
    k[:, 175:] = float("nan")           # past every k_valid: never read
    v[:, 175:] = float("nan")
    verify = flash_attention_fwd(q, k, v, q_start=q_start,
                                 k_valid_len=q_start + 5, window=window)
    for i in range(5):
        one = flash_attention_fwd(q[:, i:i + 1], k, v, q_start=q_start + i,
                                  k_valid_len=q_start + i + 1, window=window)
        assert torch.equal(_bits(verify[:, i:i + 1]), _bits(one)), i
    assert not bool(verify.isnan().any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,softcap", [(None, None), (37, None),
                                            (None, 30.0)])
def test_dense_row_equals_paged_row(card, dtype, window, softcap):
    """A dense one-row call equals the paged kernel over pages that hold
    the same bits, bit for bit (DESIGN.md Sec. 14, on the card)."""
    B, H, KV, D, ps, maxp = 3, 4, 1, 256, 16, 12
    q, kp, vp, table = _paged_case(card, dtype, B=B, H=H, KV=KV, D=D, Dv=D,
                                   ps=ps, maxp=maxp, seed=11)
    q = q[:, :1]
    S = maxp * ps
    k = kp[table.long()].reshape(B, S, KV, D)
    v = vp[table.long()].reshape(B, S, KV, D)
    pos = torch.tensor([0, 63, 150], device=card, dtype=torch.int32)
    kw = dict(window=window, softcap=softcap)
    paged = paged_flash_attention_fwd(q, kp, vp, table, q_start=pos,
                                      k_valid_len=pos + 1, **kw)
    dense = flash_attention_fwd(q, k, v, q_start=pos, k_valid_len=pos + 1,
                                **kw)
    assert torch.equal(_bits(dense), _bits(paged))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tq,window", [(1, None), (1, 40), (5, None)])
def test_split_equals_unsplit(card, dtype, Tq, window):
    """Split over the key axis (2 to 17 blocks per row tile, partials
    folded by the combine kernel) equals kv_splits=1 bit for bit, in both
    kernels; the combine launches are counted apart."""
    B, H, KV, D, ps, maxp = 4, 4, 1, 256, 16, 68
    q, kp, vp, table = _paged_case(card, dtype, B=B, H=H, KV=KV, D=D, Dv=D,
                                   ps=ps, maxp=maxp, seed=13)
    q = q[:, :Tq]
    S = maxp * ps
    k = kp[table.long()].reshape(B, S, KV, D)
    v = vp[table.long()].reshape(B, S, KV, D)
    pos = torch.tensor([64, 512, 1000, S - Tq], device=card,
                       dtype=torch.int32)
    kw = dict(q_start=pos, k_valid_len=pos + Tq, window=window)
    calls = ((flash_attention_fwd, (q, k, v)),
             (paged_flash_attention_fwd, (q, kp, vp, table)))
    for fn, args in calls:
        one = fn(*args, kv_splits=1, **kw)
        for splits in (2, 3, 5, 17):
            before = (fn.launches, fn.combine_launches)
            got = fn(*args, kv_splits=splits, **kw)
            assert (fn.launches, fn.combine_launches) == (before[0] + 1,
                                                          before[1] + 1)
            assert torch.equal(_bits(got), _bits(one)), (fn, splits)
    torch.cuda.synchronize()


def test_paged_kernel_rejects_what_it_does_not_take(card):
    q = torch.randn(2, 1, 4, 64, device=card)
    kp = torch.randn(5, 8, 1, 64, device=card)
    table = torch.ones(2, 2, dtype=torch.int32, device=card)
    kw = dict(q_start=0, k_valid_len=1)
    with pytest.raises(TypeError, match="int32"):
        paged_flash_attention_fwd(q, kp, kp, table.long(), **kw)
    with pytest.raises(TypeError, match="dtype"):
        paged_flash_attention_fwd(q.to(torch.bfloat16), kp, kp, table, **kw)
    with pytest.raises(ValueError, match="shapes"):
        paged_flash_attention_fwd(q, kp, kp, table[:1], **kw)
    with pytest.raises(ValueError, match="CUDA"):
        paged_flash_attention_fwd(q, kp, kp, table.cpu(), **kw)
    with pytest.raises(ValueError, match="instantiated"):
        paged_flash_attention_fwd(q[..., :32], kp[..., :32], kp[..., :32],
                                  table, **kw)


def test_continuous_engine_on_the_card_matches_the_cpu(card):
    """A short trace through the continuous engine on reduced gemma3-1b in
    f32: the card's greedy tokens and statistics are the CPU's, plainly
    and speculatively, and every model pass of a decode step goes through
    the paged kernel, one launch per layer it runs."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import (ContinuousEngine, PagedCacheLayout,
                                   poisson_trace)
    cfg = get_config("gemma3-1b").reduced()
    cpu = M.init(cfg, seed=3, dtype=torch.float32, device="cpu")
    dev = M.Model(cfg, dtype=torch.float32, device=card)
    dev.load_state_dict(cpu.state_dict())
    trace = poisson_trace(6, rate=1.0, seed=2, min_prompt=3, max_prompt=14,
                          vocab_size=cfg.vocab_size)
    for kw in (dict(), dict(speculate_k=2, draft_layers=0)):
        out = {}
        for name, params, d in (("cpu", cpu, "cpu"), ("card", dev, card)):
            eng = ContinuousEngine(
                cfg, slots=3, layout=PagedCacheLayout(
                    page_size=4, num_pages=19, max_pages_per_slot=6),
                max_new=5, buckets=(4, 8, 16), param_dtype=torch.float32,
                cache_dtype=torch.float32, device=d, **kw)
            before = paged_flash_attention_fwd.launches
            out[name] = eng.run(params, trace)
            launches = paged_flash_attention_fwd.launches - before
        steps = out["card"]["stats"]["dispatches"]["decode"]
        per_step = cfg.num_layers * (1 + kw.get("speculate_k", 0))
        if kw:     # the draft runs the prologue only
            per_step = cfg.num_layers + kw["speculate_k"] * len(cfg.prologue)
        assert launches == steps * per_step
        for rid, r in out["cpu"]["results"].items():
            assert out["card"]["results"][rid].tokens == r.tokens, (kw, rid)
        assert out["card"]["stats"] == out["cpu"]["stats"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tq,window,softcap", [(1, None, None), (5, 512, None),
                                               (5, None, None),
                                               (3, 40, 30.0)])
def test_sdpa_decode_matches_plain_at_ragged_positions(card, dtype, Tq,
                                                       window, softcap):
    """``ops.sdpa_decode`` on the card launches the dense kernel once at
    per-request positions (one request at position 0) and matches the
    plain ``grouped_sdpa_decode_ref``; each request's cache tail past its
    k_valid holds NaN, which neither reads."""
    g = torch.Generator(device=card).manual_seed(Tq + (window or 0))
    B, S, H, KV, D = 4, 1092, 4, 1, 256
    q = torch.randn(B, Tq, H, D, generator=g, device=card).to(dtype)
    k = torch.randn(B, S, KV, D, generator=g, device=card).to(dtype)
    v = torch.randn(B, S, KV, D, generator=g, device=card).to(dtype)
    q_start = torch.tensor([0, 400, 1024, S - Tq], device=card)
    for b, n in enumerate((q_start + Tq).tolist()):
        k[b, n:] = float("nan")
        v[b, n:] = float("nan")
    kw = dict(q_start=q_start, k_valid_len=q_start + Tq, window=window,
              softcap=softcap)
    before = flash_attention_fwd.launches
    with torch.inference_mode():
        got = ops.sdpa_decode(q, k, v, **kw)
    assert flash_attention_fwd.launches == before + 1
    _assert_close(got, ref.grouped_sdpa_decode_ref(q, k, v, **kw))
    assert not bool(got.isnan().any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 512])
def test_sdpa_decode_verify_window_equals_one_row_calls(card, dtype, window):
    """The fixed-batch engine's verify at gemma3-1b's serving shape (B=4,
    k + 1 = 5 rows, a cache of 1092 positions, per-request positions)
    equals the 5 one-row calls of plain decoding bit for bit."""
    g = torch.Generator(device=card).manual_seed(7 + (window or 0))
    B, S, H, KV, D = 4, 1092, 4, 1, 256
    q = torch.randn(B, 5, H, D, generator=g, device=card).to(dtype)
    k = torch.randn(B, S, KV, D, generator=g, device=card).to(dtype)
    v = torch.randn(B, S, KV, D, generator=g, device=card).to(dtype)
    pos = torch.tensor([1024, 1041, 1063, S - 5], device=card)
    with torch.inference_mode():
        verify = ops.sdpa_decode(q, k, v, q_start=pos, k_valid_len=pos + 5,
                                 window=window)
        for i in range(5):
            one = ops.sdpa_decode(q[:, i:i + 1], k, v, q_start=pos + i,
                                  k_valid_len=pos + i + 1, window=window)
            assert torch.equal(_bits(verify[:, i:i + 1]), _bits(one)), i


def _spec_models(card, cfg, seed):
    from repro_torch.models import model as M
    cpu = M.init(cfg, seed=seed, dtype=torch.float32, device="cpu")
    dev = M.Model(cfg, dtype=torch.float32, device=card)
    dev.load_state_dict(cpu.state_dict())
    return cpu, dev


def test_fixed_batch_speculation_on_the_card_matches_the_cpu(card):
    """Reduced gemma3-1b in f32 (2 pattern blocks): the fixed-batch
    engine's greedy tokens, lengths and SpecStats on the card are the
    CPU's, self-speculative and with a 1-block draft model; its tokens
    are the plain engine's; and every attention call goes to the flash
    kernel, as many launches as the rounds make (prefill: one per layer;
    a round: k draft steps of the draft's layers, the draft model's
    write-only step, one verify over every layer)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serve import make_engine
    cfg = get_config("gemma3-1b").reduced(num_blocks=2)
    dcfg = dataclasses.replace(cfg, num_blocks=1)
    target = _spec_models(card, cfg, 3)
    draft = _spec_models(card, dcfg, 4)
    tokens = torch.randint(0, cfg.vocab_size, (3, 11),
                           generator=torch.Generator().manual_seed(5))
    k, pro, blk = 2, len(cfg.prologue), len(cfg.pattern)
    cases = {"plain": (dict(), None),
             "self": (dict(speculate_k=k, draft_layers=1), None),
             "draft": (dict(speculate_k=k, draft_cfg=dcfg), draft)}
    out = {}
    for name, (kw, dparams) in cases.items():
        for side, i, d in (("cpu", 0, torch.device("cpu")),
                           ("card", 1, card)):
            eng = make_engine(cfg, batch=3, prompt_len=11, max_new=9,
                              param_dtype=torch.float32,
                              cache_dtype=torch.float32, device=d, **kw)
            before = flash_attention_fwd.launches
            out[name, side] = eng.generate_with_state(
                target[i], {"tokens": tokens.to(d)},
                draft_params=None if dparams is None else dparams[i])
            launches = flash_attention_fwd.launches - before
        res = out[name, "card"]
        if name == "self":
            rounds = int(res.spec.rounds.max())
            want = cfg.num_layers + rounds * (
                k * (pro + blk) + cfg.num_layers)
        elif name == "draft":
            rounds = int(res.spec.rounds.max())
            want = cfg.num_layers + dcfg.num_layers + rounds * (
                (k + 1) * dcfg.num_layers + cfg.num_layers)
        else:
            want = cfg.num_layers * 9
        assert launches == want, name
        cpu = out[name, "cpu"]
        for f in ("tokens", "done", "lengths"):
            assert torch.equal(getattr(res, f).cpu(), getattr(cpu, f)), \
                (name, f)
        if name != "plain":
            for f in res.spec._fields:
                assert torch.equal(getattr(res.spec, f).cpu(),
                                   getattr(cpu.spec, f)), (name, f)
            assert torch.equal(res.tokens, out["plain", "card"].tokens)
    assert int(out["self", "card"].spec.accepted.sum()) \
        < int(out["self", "card"].spec.drafted.sum())


# ---------------------------------------------------------------------------
# the multi-config sweep's grouped launches (repro_torch.sim.sweep)
# ---------------------------------------------------------------------------

def _copies(G, n, shapes, seed, card):
    g = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn((G * n,) + s, generator=g, device=card)
            for s in shapes]


MLP_SHAPES = [(32, 64), (64,), (64, 10), (10,)]


@pytest.mark.parametrize("G,n", [(10, 16), (6, 3), (1, 8)])
def test_fused_dsgd_many_over_sweep_copies_equals_per_copy_launches(card, G,
                                                                   n):
    """The sweep's update: one grouped launch over G copies' stacked
    leaves, pre-scale each copy's own per-node vector, equals G launches
    over each copy's (n, ...) leaves, bit for bit."""
    xs, us, gs = (_copies(G, n, MLP_SHAPES, s, card) for s in (1, 2, 3))
    pre = torch.rand(G * n, device=card) + 0.2
    before = fused_dsgd_many.launches
    got_x, got_u = ops.fused_dsgd_steps(xs, us, gs, 0.9, 0.05, pre)
    assert fused_dsgd_many.launches == before + 1
    for c in range(G):
        sl = slice(c * n, (c + 1) * n)
        wx, wu = ops.fused_dsgd_steps(
            [x[sl].clone() for x in xs], [u[sl].clone() for u in us],
            [g[sl].clone() for g in gs], 0.9, 0.05, pre[sl].clone())
        for a, b in zip(got_x + got_u, wx + wu):
            assert torch.equal(_bits(a[sl]), _bits(b))


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantize_ef_many_over_sweep_copies_equals_per_copy_launches(card,
                                                                    fmt):
    """The compressed sweep's quantize: every copy's chunk-row records in
    one grouped launch, each from row offset 0, equal each copy's own
    launch bit for bit."""
    from repro_torch.compress.mixing import group_to_rows
    G, n, chunk = 6, 16, 256
    leaves = _copies(G, n, MLP_SHAPES, 4, card)
    errs = _copies(G, n, MLP_SHAPES, 5, card)
    rows = [group_to_rows([x[c * n:(c + 1) * n]], chunk)
            for x in leaves for c in range(G)]
    erows = [group_to_rows([e[c * n:(c + 1) * n]], chunk)
             for e in errs for c in range(G)]
    key = ref.sr_key(0, 3)
    before = quantize_ef_many.launches
    got = ops.quantize_payload_many(rows, erows, fmt=fmt, key=key,
                                    row_offsets=[0] * len(rows))
    assert quantize_ef_many.launches == before + 1
    per = len(MLP_SHAPES)
    for c in range(G):
        mine = [i * G + c for i in range(per)]
        want = ops.quantize_payload_many(
            [rows[i].clone() for i in mine], [erows[i].clone() for i in mine],
            fmt=fmt, key=key, row_offsets=[0] * per)
        for outs, wants in zip(got, want):
            for i, w in zip(mine, wants):
                assert torch.equal(outs[i].view(torch.uint8),
                                   w.view(torch.uint8))


@pytest.mark.parametrize("compression,failure", [
    (None, None), (None, "drop+delay"), ("int8", None)])
def test_sweep_on_the_card_equals_its_single_runs(card, compression,
                                                  failure):
    """A sweep on the card: every cell equals its independent run on the
    card bit for bit, with one grouped fused update per step (and for
    int8 one grouped quantize per step) over every copy."""
    from repro_torch.configs.paper_mlp import MLPConfig
    from repro_torch.data.synthetic import dirichlet_classification
    from repro_torch.models import mlp
    from repro_torch.optim.decentralized import make_method
    from repro_torch.sim import (FailureModel, simulate_decentralized,
                                 sweep_decentralized)
    from repro_torch.topology import TopologySpec

    n, steps = 16, 12
    cfg = MLPConfig(input_dim=32, hidden=(64,), num_classes=10)
    data = dirichlet_classification(n, 256, dim=32, alpha=0.3, seed=2)
    seeds = [mlp.init(cfg, seed=s, device=card) for s in (0, 1)]
    specs = [TopologySpec("base", n, 1), TopologySpec("exp", n),
             TopologySpec("ring", n)]
    fm = None if failure is None else FailureModel(drop_rate=0.2, delay=2,
                                                   seed=3)
    method = make_method("dsgd" if compression else "dsgdm",
                         compression=compression)

    def batches(step, bs=32):
        i = (step * bs) % (256 - bs)
        return data.node_x[:, i:i + bs], data.node_y[:, i:i + bs]

    kw = dict(loss_fn=mlp.loss_fn, method=method, batches=batches,
              steps=steps, eta=0.05, failure=fm, device=card)
    b_dsgd, b_quant = fused_dsgd_many.launches, quantize_ef_many.launches
    sw = sweep_decentralized(params=seeds, schedules=specs, **kw)
    if compression:
        assert quantize_ef_many.launches - b_quant == steps
    else:
        assert fused_dsgd_many.launches - b_dsgd == steps
    for c, spec in enumerate(specs):
        for s, p in enumerate(seeds):
            one = simulate_decentralized(params=p, schedule=spec, **kw)
            cell = sw.run(c, s)
            assert (one.losses == cell.losses).all(), (c, s)
            for k, x in one.params.items():
                assert torch.equal(_bits(x), _bits(cell.params[k])), k
            if fm is not None:
                assert (one.clocks == cell.clocks).all()


# ---------------------------------------------------------------------------
# the dense zoo's head layouts (gemma2-2b, granite-8b, qwen1.5-4b)
# ---------------------------------------------------------------------------

def _zoo_heads(arch):
    """(H, KV, hd, the local layers' window or None, softcap)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    window = max((s.window or 0 for s in cfg.pattern), default=0) or None
    return (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, window,
            cfg.attn_softcap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch,window", [("granite-8b", None),
                                         ("qwen1.5-4b", None),
                                         ("gemma2-2b", None),
                                         ("gemma2-2b", 24)])
def test_zoo_head_layouts_match_plain(card, arch, window, dtype):
    """Rows 1 and 2 at each zoo arch's head layout (granite-8b 32 q / 8
    kv heads of 128, qwen1.5-4b 20 / 20 of 128, gemma2-2b 8 / 4 of 256
    with softcap 50), small B and S: a prefill continuation and ragged
    decode rows (dense), and decode rows over pages of 16 (paged),
    against the plain versions; gemma2-2b's local layer with a window
    that binds at this S (its 4096 is taken whole in the next test)."""
    H, KV, D, _, softcap = _zoo_heads(arch)
    g = torch.Generator(device=card).manual_seed(len(arch) + H)
    B, S = 2, 96
    q = torch.randn(B, 40, H, D, generator=g, device=card).to(dtype)
    k, v = (torch.randn(B, S, KV, D, generator=g, device=card).to(dtype)
            for _ in range(2))
    kw = dict(window=window, softcap=softcap)
    got = ops.sdpa(q, k, v, q_pos0=50, k_valid_len=90, **kw)
    _assert_close(got, ref.grouped_sdpa_ref(q, k, v, q_pos0=50,
                                            k_valid_len=90, **kw))
    pos = torch.tensor([7, S - 1], device=card, dtype=torch.int32)
    got = ops.sdpa_decode(q[:, :1], k, v, q_start=pos, k_valid_len=pos + 1,
                          **kw)
    _assert_close(got, ref.grouped_sdpa_decode_ref(
        q[:, :1], k, v, q_start=pos, k_valid_len=pos + 1, **kw))
    qp, kp, vp, table = _paged_case(card, dtype, B=B, H=H, KV=KV, D=D, Dv=D,
                                    ps=16, maxp=6, seed=H)
    before = paged_flash_attention_fwd.launches
    got = ops.paged_sdpa(qp[:, :1], kp, vp, table, q_start=pos,
                         k_valid_len=pos + 1, **kw)
    assert paged_flash_attention_fwd.launches == before + 1
    assert not bool(got.isnan().any())
    _assert_close(got, ref.paged_sdpa_ref(qp[:, :1], kp, vp, table,
                                          q_start=pos, k_valid_len=pos + 1,
                                          **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_4096_split_decode_equals_unsplit(card, dtype):
    """gemma2-2b's local layer at S > 4096: decode rows whose window of
    4096 keys binds, split over the key axis (the wrapper's choice and 2
    to 33 blocks), equal kv_splits=1 bit for bit and the plain version
    within tolerance."""
    H, KV, D, window, softcap = _zoo_heads("gemma2-2b")
    assert window == 4096
    g = torch.Generator(device=card).manual_seed(4096)
    B, S = 2, 4240
    q = torch.randn(B, 1, H, D, generator=g, device=card).to(dtype)
    k, v = (torch.randn(B, S, KV, D, generator=g, device=card).to(dtype)
            for _ in range(2))
    pos = torch.tensor([4100, S - 1], device=card, dtype=torch.int32)
    kw = dict(q_start=pos, k_valid_len=pos + 1, window=window,
              softcap=softcap)
    one = flash_attention_fwd(q, k, v, kv_splits=1, **kw)
    _assert_close(one, ref.grouped_sdpa_decode_ref(q, k, v, **kw))
    for splits in (None, 2, 7, 33):
        got = flash_attention_fwd(q, k, v, kv_splits=splits, **kw)
        assert torch.equal(_bits(got), _bits(one)), splits
    assert flash_attention_fwd.last_launch["splits"] == 33
    torch.cuda.synchronize()


def test_qkv_bias_attention_forward_on_the_card(card):
    """One attention layer with QKV biases (qwen1.5-4b's layout, reduced)
    on the card against the same layer on the CPU, in f32: one flash
    launch, the results within the plain version's tolerance of the
    CPU's (cuBLAS and the kernel sum in other orders)."""
    from repro_torch.models.attention import Attention
    g = torch.Generator().manual_seed(5)
    layer = Attention(256, 4, 4, 64, qkv_bias=True, dtype=torch.float32,
                      device="cpu")
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=g))
    x = torch.randn(2, 9, 256, generator=g)
    want = layer(x)
    before = flash_attention_fwd.launches
    got = layer.to(card)(x.to(card))
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    assert layer.wq.b is not None and layer.wo.b is None
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,Dv", [(48, 32), (64, 32)])
def test_padded_head_dims_match_plain(card, dtype, D, Dv):
    """Head dims the kernel is not instantiated for (reduced MLA's
    (48, 32), the reference's MLA test family (64, 32)): through
    ``ops.sdpa`` and ``ops.sdpa_decode`` the wrapper zero-pads them to
    (64, 64) with the scale of the true D, launches once, counts that
    launch under (D, Dv), and equals the kernel on the hand-padded
    inputs bit for bit and the plain version on the unpadded ones within
    its tolerance."""
    import torch.nn.functional as F
    g = torch.Generator(device=card).manual_seed(D + Dv)
    B, H, KV, Tq, S = 2, 4, 4, 9, 40
    q = torch.randn(B, Tq, H, D, generator=g, device=card).to(dtype)
    k = torch.randn(B, S, KV, D, generator=g, device=card).to(dtype)
    v = torch.randn(B, S, KV, Dv, generator=g, device=card).to(dtype)
    scale = 48 ** -0.5          # MLA passes qk_dim ** -0.5 explicitly
    pos = torch.tensor([20, 31], device=card, dtype=torch.int32)
    for kw, plain, call in (
            (dict(q_pos0=5, k_valid_len=14), ref.grouped_sdpa_ref, ops.sdpa),
            (dict(q_start=pos, k_valid_len=pos + Tq),
             ref.grouped_sdpa_decode_ref, ops.sdpa_decode)):
        for sc in (scale, None):
            before = flash_attention_fwd.launches
            pair = flash_attention_fwd.launches_by_dims[(D, Dv)]
            got = call(q, k, v, scale=sc, softcap=30.0, **kw)
            torch.cuda.synchronize()
            assert flash_attention_fwd.launches == before + 1
            assert flash_attention_fwd.launches_by_dims[(D, Dv)] == pair + 1
            assert got.shape == (B, Tq, H, Dv) and got.dtype == dtype
            _assert_close(got, plain(q, k, v, scale=sc, softcap=30.0, **kw))
            fkw = {("q_start" if n == "q_pos0" else n): x
                   for n, x in kw.items()}
            padded = flash_attention_fwd(
                F.pad(q, (0, 64 - D)), F.pad(k, (0, 64 - D)),
                F.pad(v, (0, 64 - Dv)), softcap=30.0,
                scale=D ** -0.5 if sc is None else sc, **fkw)
            assert torch.equal(_bits(got), _bits(padded[..., :Dv]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Tq,q0,valid", [(40, 0, 40), (1, 70, 71),
                                         (5, 66, 71)])
def test_six_query_heads_per_kv_head_with_softcap(card, dtype, Tq, q0,
                                                  valid):
    """grok-1's head layout: 6 query heads per kv head (12 / 2 here, 48 / 8
    there), hd 128, softcap 30 in every layer; prefill, decode and a
    verify window, NaN past k_valid, against the plain version; a decode
    row split over the key axis equals unsplit bit for bit."""
    g = torch.Generator(device=card).manual_seed(6 + Tq)
    B, H, KV, D, S = 2, 12, 2, 128, 96
    q = torch.randn(B, Tq, H, D, generator=g, device=card).to(dtype)
    k = torch.randn(B, S, KV, D, generator=g, device=card).to(dtype)
    v = torch.randn(B, S, KV, D, generator=g, device=card).to(dtype)
    k[:, valid:] = float("nan")
    v[:, valid:] = float("nan")
    kw = dict(softcap=30.0, q_start=q0, k_valid_len=valid)
    got = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_close(got, ref.grouped_sdpa_ref(q, k, v, softcap=30.0,
                                            q_pos0=q0, k_valid_len=valid))
    if Tq == 1:
        one = flash_attention_fwd(q, k, v, kv_splits=1, **kw)
        for splits in (None, 2, 5):
            assert torch.equal(_bits(flash_attention_fwd(
                q, k, v, kv_splits=splits, **kw)), _bits(one))


def test_moe_combine_is_bitwise_across_runs_at_top_8(card):
    """An MoE layer of 16 experts, top-8, one shared expert, in bf16 on the
    card, 256 tokens: two runs give the same bits (the combine adds each
    token's terms in a fixed order, where ``index_add_`` would add
    through atomics in an order that changes from run to run)."""
    from repro_torch.configs import MoEConfig
    from repro_torch.models import moe
    cfg = MoEConfig(num_experts=16, top_k=8, d_expert=64, num_shared=1)
    g = torch.Generator().manual_seed(8)
    layer = moe.MoE(128, cfg, act="silu", dtype=torch.bfloat16,
                    device="cpu")
    layer.reset_parameters(g)
    layer = layer.to(card)
    x = torch.randn(4, 64, 128, generator=g).bfloat16().to(card)
    with torch.inference_mode():
        a, aux_a = layer(x)
        b, aux_b = layer(x)
        r = moe.route(x.reshape(-1, 128), layer.router, cfg)
        t1, t2 = moe.combine_table(r), moe.combine_table(r)
    torch.cuda.synchronize()
    assert torch.equal(_bits(a), _bits(b)) and torch.equal(aux_a, aux_b)
    assert torch.equal(t1, t2) and t1.shape == (256, 8)
