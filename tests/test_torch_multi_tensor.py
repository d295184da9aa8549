"""The grouped launches' host side on the CPU: the segment tables that
feed one kernel launch over a list of tensors
(``repro_torch.kernels.multi_tensor``, read by ``csrc/multi_tensor.cuh``),
the grouped entry points ``ops.fused_dsgd_steps`` and
``ops.gossip_mix_many`` on their plain versions, and the distributed
mixer's buckets (``dist.gossip.plan_buckets``).

Tolerances:
- ``ops.fused_dsgd_steps`` against ``ops.fused_dsgd_step`` leaf by leaf,
  and against the reference's ``ref.fused_dsgd_ref``: bit for bit (the
  same f32 steps, one op each, in the same order).  Against the
  reference's Pallas kernel in interpret mode: the tolerances of
  ``tests/test_torch_fused_dsgd.py`` (XLA contracts the kernel body into
  FMAs on the CPU: four f32 roundings of the terms, plus one bf16
  rounding step in bf16).
- ``ops.gossip_mix_many`` against ``ops.gossip_mix`` tensor by tensor:
  bit for bit, and a bf16 output equals the f32 combine cast to bf16.
"""
import functools
import re
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ops import KernelConfig
from repro_torch.configs import get_config
from repro_torch.dist.gossip import BUCKET_BYTES, plan_buckets
from repro_torch.kernels import multi_tensor as mt
from repro_torch.kernels import ops, ref
from repro_torch.models import model as M

PALLAS = KernelConfig(backend="pallas", interpret=True)
BETA, ETA, NODES = 0.9, 0.01, 3
F32_ROUNDINGS = 4 * 2.0 ** -24
HEADER = (Path(mt.__file__).parent / "csrc" / "multi_tensor.cuh").read_text()


# ---------------------------------------------------------------------------
# the segment tables
# ---------------------------------------------------------------------------

def _records(table, nptr):
    """The table's records as (pointers, numel, cols, chunk_end, vec)."""
    w, size = list(table.words), nptr + mt.META_WORDS
    assert len(w) == table.segments * size
    return [(tuple(w[i:i + nptr]), *w[i + nptr:i + size])
            for i in range(0, len(w), size)]


@pytest.mark.parametrize("name,value", [
    ("kThreads", mt.THREADS), ("kUnroll", mt.UNROLL),
    ("kTableWords", mt.TABLE_WORDS), ("kMeta", mt.META_WORDS),
    ("kRowMeta", mt.ROW_META_WORDS), ("kRowChunkElems", mt.ROW_CHUNK_ELEMS)])
def test_constants_match_the_header(name, value):
    m = re.search(rf"\b{name} = (\d+)", HEADER)
    assert m and int(m.group(1)) == value


@pytest.mark.parametrize("elt", [2, 4])
def test_chunk_prefix_sums(elt):
    chunk = mt.chunk_elems(elt)
    assert chunk == 256 * 4 * (16 // elt)
    numels = [1, chunk, chunk + 1, 3 * chunk, chunk - 1]
    (table,) = mt.build_tables([((16, 32), n, 0) for n in numels], elt)
    recs = _records(table, 2)
    assert [r[3] for r in recs] == [1, 2, 4, 7, 8]
    assert [r[1] for r in recs] == numels
    assert table.chunks == 8 and table.segments == 5


def test_vector_flag_needs_alignment_and_whole_vector_rows():
    aligned = torch.empty(64 * 1000, dtype=torch.bfloat16)
    off = torch.empty(64 * 1000 + 1, dtype=torch.bfloat16)[1:]   # 2 bytes
    assert aligned.data_ptr() % 16 == 0 and off.data_ptr() % 16 == 2
    a, o = aligned.data_ptr(), off.data_ptr()
    cases = [((a, a), 1000, 1), ((a, a), 1001, 0), ((a, a), 0, 1),
             ((a, o), 1000, 0), ((o, a), 0, 0), ((a, a + 16), 8, 1)]
    (table,) = mt.build_tables([(p, 64 * 1000, c) for p, c, _ in cases], 2)
    assert [r[4] for r in _records(table, 2)] == [v for *_, v in cases]
    # f32: a vector is 4 elements, so a row of 1000 + 4 k takes it
    (table,) = mt.build_tables([((a,), 12, 4), ((a,), 12, 6)], 4)
    assert [r[4] for r in _records(table, 1)] == [1, 0]
    assert mt.vector_ok((a,), 1000, 2) and not mt.vector_ok((o,), 1000, 2)


def test_empty_leaves_are_left_out():
    segs = [((16,), 0, 0), ((32,), 5, 0), ((48,), 0, 0), ((64,), 9000, 0)]
    (table,) = mt.build_tables(segs, 2)
    recs = _records(table, 1)
    assert [r[0] for r in recs] == [(32,), (64,)]
    assert [r[3] for r in recs] == [1, 3]
    assert mt.build_tables([((16,), 0, 0)] * 3, 4) == []
    assert mt.build_tables([], 4) == []


def test_dtype_groups_keep_first_met_order():
    keys = [torch.float32, torch.bfloat16, torch.float32, torch.bfloat16,
            torch.float32]
    assert mt.groups(keys) == {torch.float32: [0, 2, 4],
                               torch.bfloat16: [1, 3]}
    assert list(mt.groups(["b", "a", "b"])) == ["b", "a"]


def test_a_segment_past_2_31_elements():
    """Built from the index arithmetic alone: nothing is allocated."""
    big = (1 << 31) + 5
    chunk = mt.chunk_elems(2)
    (table,) = mt.build_tables([((1 << 40, 2 << 40), big, big // 1),
                                ((3 << 40, 4 << 40), 7, 0)], 2)
    recs = _records(table, 2)
    first = -(-big // chunk)
    assert recs[0] == ((1 << 40, 2 << 40), big, big, first, 0)
    assert recs[1][3] == first + 1 and first * chunk >= big > (
        first - 1) * chunk
    (table,) = mt.build_tables([((16,), 3 * (1 << 31), 1 << 31)], 2)
    assert _records(table, 1)[0][1:] == (3 << 31, 1 << 31,
                                         3 * (1 << 31) // chunk, 1)


@pytest.mark.parametrize("nptr", [3, 5, 33])
def test_a_list_past_one_table_splits(nptr):
    cap = mt.capacity(nptr)
    assert cap * (nptr + mt.META_WORDS) <= mt.TABLE_WORDS
    segs = [((16 * (i + 1),) * nptr, 10 + i, 0) for i in range(2 * cap + 1)]
    tables = mt.build_tables(segs, 4)
    assert [t.segments for t in tables] == [cap, cap, 1]
    for t in tables:
        assert len(t.words) <= mt.TABLE_WORDS
        assert _records(t, nptr)[0][3] == 1       # prefix sums restart
        assert t.chunks == t.segments
    assert mt.capacity(5) == 440 and mt.capacity(3) == 566


def test_segments_take_one_pointer_count():
    with pytest.raises(ValueError, match="pointers"):
        mt.build_tables([((16, 32), 4, 0), ((16,), 4, 0)], 4)
    with pytest.raises(ValueError, match=">= 0"):
        mt.build_tables([((16,), -1, 0)], 4)


# ---------------------------------------------------------------------------
# row tables (the quantize+EF and quantized combine kernels)
# ---------------------------------------------------------------------------

QUANT_RULE = (256, 256)          # quantized_gossip.cu's vector rows
MIX_RULE = (128, (1 << 63) - 1)


@pytest.mark.parametrize("cols,per", [(1, 4096), (2, 2048), (6, 682),
                                      (256, 16), (512, 8), (1024, 8),
                                      (4096, 8), (70001, 8)])
def test_rows_per_chunk_fills_the_budget_and_every_warp(cols, per):
    assert mt.rows_per_chunk(cols) == per
    assert per >= mt.WARPS == 8
    assert per * cols <= mt.ROW_CHUNK_ELEMS or per == mt.WARPS


def test_row_tables_cut_whole_rows_and_carry_row_offsets():
    segs = [((16, 32), 16, 256, 0), ((48, 64), 17, 256, 3 << 32),
            ((80, 96), 5, 6, 7), ((112, 128), 2049, 2, -3),
            ((144, 160), 9, 1024, 1)]
    (table,) = mt.build_row_tables(segs, *QUANT_RULE)
    size = 2 + mt.ROW_META_WORDS
    w = list(table.words)
    recs = [w[i:i + size] for i in range(0, len(w), size)]
    # chunks: 16/16 = 1; 17/16 -> 2; 5 rows of 6 -> 1; 2049/2048 -> 2;
    # 9 rows of 1024, 8 per chunk -> 2
    # a record: 2 pointers, numel, cols, chunk_end, vec, row_offset
    assert [r[4] for r in recs] == [1, 3, 4, 6, 8]
    assert [r[2] for r in recs] == [16 * 256, 17 * 256, 30, 4098, 9216]
    assert [r[3] for r in recs] == [256, 256, 6, 2, 1024]
    assert [r[6] for r in recs] == [0, 3 << 32, 7, (1 << 64) - 3, 1]
    assert table.chunks == 8 and table.segments == 5


def test_row_vector_flag_follows_each_kernels_rule():
    a = torch.empty(4096).data_ptr()
    assert a % 16 == 0
    segs = [((a, a), 4, 256, 0), ((a, a + 4), 4, 256, 0),
            ((a, a), 4, 512, 0), ((a, a), 4, 384, 0), ((a, a), 4, 250, 0),
            ((a, a + 32), 4, 128, 0)]
    for rule, want in ((QUANT_RULE, [1, 0, 0, 0, 0, 0]),
                       (MIX_RULE, [1, 0, 1, 1, 0, 1])):
        (table,) = mt.build_row_tables(segs, *rule)
        w = list(table.words)
        size = 2 + mt.ROW_META_WORDS
        assert [w[i + 5] for i in range(0, len(w), size)] == want
    assert mt.row_vector_ok((a,), 256, *QUANT_RULE)
    assert not mt.row_vector_ok((a + 8,), 256, *QUANT_RULE)


@pytest.mark.parametrize("nptr", [4, 5, 8])
def test_a_row_list_past_one_table_splits(nptr):
    cap = mt.capacity(nptr, mt.ROW_META_WORDS)
    assert cap * (nptr + mt.ROW_META_WORDS) <= mt.TABLE_WORDS
    segs = [((16 * (i + 1),) * nptr, 1 + i % 16, 256, i)
            for i in range(2 * cap + 1)]       # one chunk of rows each
    tables = mt.build_row_tables(segs, *QUANT_RULE)
    assert [t.segments for t in tables] == [cap, cap, 1]
    for t in tables:
        assert len(t.words) <= mt.TABLE_WORDS
        assert t.words[nptr + 2] == 1          # prefix sums restart
        assert t.chunks == t.segments
    # 396 quantize records with err, 440 with one payload, 305 with three
    assert mt.capacity(5, mt.ROW_META_WORDS) == 396
    assert mt.capacity(4, mt.ROW_META_WORDS) == 440
    assert mt.capacity(8, mt.ROW_META_WORDS) == 305


def test_row_tables_leave_out_empty_buffers_and_reject_bad_ones():
    segs = [((16,), 0, 256, 0), ((32,), 3, 256, 0), ((48,), 0, 2, 0)]
    (table,) = mt.build_row_tables(segs, *QUANT_RULE)
    assert table.segments == 1 and table.words[0] == 32
    assert mt.build_row_tables([((16,), 0, 256, 0)], *QUANT_RULE) == []
    with pytest.raises(ValueError, match="cols"):
        mt.build_row_tables([((16,), 3, 0, 0)], *QUANT_RULE)
    with pytest.raises(ValueError, match="pointers"):
        mt.build_row_tables([((16,), 3, 2, 0), ((16, 32), 3, 2, 0)],
                            *QUANT_RULE)


def test_gemma3_1b_reference_leaf_buckets():
    """The compressed mixers' buckets of gemma3-1b's 106 reference leaves
    at the default cap: 29 for the simulation's 3 nodes, 14 for one
    rank's rows; the embedding alone in its bucket, and every leaf past
    the cap too."""
    from repro_torch.compress import reference_leaves
    from repro_torch.compress.mixing import rows_bytes
    shapes = _shapes(reduced=False)
    leaves = reference_leaves(shapes)
    assert len(leaves) == 106
    for n, want in ((3, 29), (1, 14)):
        sizes = [rows_bytes([torch.empty((n,) + shapes[k], device="meta")
                             for k in g], 256) for g in leaves]
        buckets = mt.plan_buckets(sizes, mt.BUCKET_BYTES)
        assert len(buckets) == want
        big = [b for b in buckets if sum(sizes[i] for i in b)
               > mt.BUCKET_BYTES]
        assert all(len(b) == 1 for b in big)
        assert [leaves.index(["embed.table"])] in buckets
        if n == 1:      # at n = 3 the MLP leaves pass the cap too
            assert len(big) == 1


# ---------------------------------------------------------------------------
# the grouped entry points on the CPU
# ---------------------------------------------------------------------------

@functools.cache
def _shapes(reduced: bool = True):
    """gemma3-1b's leaf shapes (reduced: one pattern block, narrow), on
    the meta device: nothing is allocated."""
    cfg = get_config("gemma3-1b")
    if reduced:
        cfg = cfg.reduced(num_blocks=1)
    return {k: tuple(v.shape) for k, v in M.Model(
        cfg, dtype=torch.float32, device="meta").state_dict().items()}


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(a):
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a.view(torch.int32)).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype == ml_dtypes.bfloat16 else np.int32)


def _leaves(dtype, seed):
    """numpy (x, u, g) per leaf of the tree, in ``dtype``."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in _shapes().items():
        arrs = [rng.standard_normal((NODES,) + shape, dtype=np.float32)
                for _ in range(3)]
        if dtype == "bfloat16":
            arrs = [a.astype(ml_dtypes.bfloat16) for a in arrs]
        out[k] = arrs
    return out


def _pre(mode, rng):
    if mode == "row":
        return rng.uniform(0.2, 1.0, size=NODES).astype(np.float32)
    return {"one": 1.0, "scalar": 0.37}[mode]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pre_mode", ["one", "scalar", "row"])
def test_fused_dsgd_steps_equal_the_step_and_the_reference_bitwise(
        dtype, pre_mode):
    leaves = _leaves(dtype, seed=len(pre_mode))
    pre = _pre(pre_mode, np.random.default_rng(1))
    tp = torch.from_numpy(pre) if isinstance(pre, np.ndarray) else pre
    keys = list(leaves)
    xs, us, gs = ([_torch(leaves[k][i]) for k in keys] for i in range(3))
    got_x, got_u = ops.fused_dsgd_steps(xs, us, gs, BETA, ETA, tp)
    assert len(got_x) == len(got_u) == len(keys)
    for k, x, u, g, gx, gu in zip(keys, xs, us, gs, got_x, got_u):
        wx, wu = ops.fused_dsgd_step(x, u, g, BETA, ETA, tp)
        assert gx.dtype == x.dtype and gx.shape == x.shape
        assert np.array_equal(_bits(gx), _bits(wx))
        assert np.array_equal(_bits(gu), _bits(wu))
        jp = jnp.asarray(pre) if isinstance(pre, np.ndarray) else pre
        if isinstance(pre, np.ndarray):
            jp = jp.reshape((-1,) + (1,) * (x.ndim - 1))
        jx, ju = jref.fused_dsgd_ref(*(jnp.asarray(a) for a in leaves[k]),
                                     BETA, ETA, jp)
        assert np.array_equal(_bits(gx), _bits(jx)), k
        assert np.array_equal(_bits(gu), _bits(ju)), k


def _f32(a):
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


@pytest.mark.parametrize("dtype,pre_mode", [("bfloat16", "row"),
                                            ("float32", "one")])
def test_fused_dsgd_steps_match_the_pallas_kernel_in_interpret_mode(
        dtype, pre_mode):
    leaves = _leaves(dtype, seed=7)
    pre = _pre(pre_mode, np.random.default_rng(2))
    tp = torch.from_numpy(pre) if isinstance(pre, np.ndarray) else pre
    keys = list(leaves)
    got_x, got_u = ops.fused_dsgd_steps(
        *([_torch(leaves[k][i]) for k in keys] for i in range(3)), BETA,
        ETA, tp)
    for k, tx, tu in zip(keys, got_x, got_u):
        x, u, g = leaves[k]
        jx, ju = jops.fused_dsgd_step(
            *(jnp.asarray(a) for a in (x, u, g)), BETA, ETA,
            jnp.asarray(pre) if isinstance(pre, np.ndarray) else pre,
            config=PALLAS)
        xf, uf, gf = (np.asarray(a, np.float32) for a in (x, u, g))
        p = np.asarray(pre, np.float32)
        if p.ndim:
            p = p.reshape((-1,) + (1,) * (x.ndim - 1))
        u_new = _f32(tu)
        tol_u = F32_ROUNDINGS * (np.abs(BETA * uf) + np.abs(gf))
        tol_x = np.abs(p) * (F32_ROUNDINGS * (np.abs(xf)
                                              + np.abs(ETA * u_new))
                             + ETA * tol_u)
        if dtype == "bfloat16":
            tol_u = tol_u + 2.0 ** -7 * np.abs(_f32(ju))
            tol_x = tol_x + 2.0 ** -7 * np.abs(_f32(jx))
        assert np.all(np.abs(u_new - _f32(ju)) <= tol_u), k
        assert np.all(np.abs(_f32(tx) - _f32(jx)) <= tol_x), k


def test_fused_dsgd_steps_on_no_leaves_and_bad_lists():
    assert ops.fused_dsgd_steps([], [], [], BETA, ETA) == ([], [])
    x = torch.zeros(3, 4)
    with pytest.raises(ValueError, match="x"):
        ops.fused_dsgd_steps([x, x], [x], [x], BETA, ETA)
    with pytest.raises(ValueError, match="one device"):
        ops.fused_dsgd_steps([x, x.to("meta")], [x, x], [x, x], BETA, ETA)


@pytest.mark.parametrize("S", [1, 2, 3])
@pytest.mark.parametrize("out", [None, torch.float32, torch.bfloat16])
def test_gossip_mix_many_equals_one_combine_per_tensor(S, out):
    rng = np.random.default_rng(S)
    lists = []
    for shape in list(_shapes().values())[:12]:
        dtype = torch.bfloat16 if len(lists) % 3 == 1 else torch.float32
        lists.append([torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dtype) for _ in range(S)])
    w = rng.uniform(0.1, 1.0, S).tolist()
    got = ops.gossip_mix_many(lists, w, out)
    assert len(got) == len(lists)
    for bufs, g in zip(lists, got):
        f32 = ref.gossip_mix_ref(bufs, w, out_dtype=torch.float32)
        want = ops.gossip_mix(bufs, w) if out is None else f32.to(out)
        assert g.dtype == want.dtype and g.shape == bufs[0].shape
        assert np.array_equal(_bits(g), _bits(want))
        # a bf16 output is the f32 sum rounded once: the bits of a cast
        assert np.array_equal(_bits(ops.gossip_mix(bufs, w)),
                              _bits(f32.to(bufs[0].dtype)))
    per_tensor = ops.gossip_mix_many(lists, w, [b[0].dtype for b in lists])
    for g, bufs in zip(per_tensor, lists):
        assert np.array_equal(_bits(g), _bits(ops.gossip_mix(bufs, w)))


def test_gossip_mix_many_rejects_mixed_lists():
    a = torch.zeros(2, 3)
    assert ops.gossip_mix_many([], [1.0]) == []
    with pytest.raises(ValueError, match="shape"):
        ops.gossip_mix_many([[a, a[:1]]], [0.5, 0.5])
    with pytest.raises(ValueError, match="one device"):
        ops.gossip_mix_many([[a, a], [a.to("meta"), a]], [0.5, 0.5])
    with pytest.raises(ValueError, match="buffer"):
        ops.gossip_mix_many([[a], []], [1.0])


# ---------------------------------------------------------------------------
# the distributed mixer's buckets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes,cap,want", [
    ([10, 20, 30], 100, [[0, 1, 2]]),
    ([60, 50, 40, 10], 100, [[0], [1, 2, 3]]),
    ([10, 500, 20, 20], 100, [[0], [1], [2, 3]]),     # past the cap: alone
    ([500], 100, [[0]]),
    ([1, 2, 3], 0, [[0], [1], [2]]),                   # one per tensor
    ([], 100, []),
])
def test_plan_buckets(sizes, cap, want):
    assert plan_buckets(sizes, cap) == want


def test_gemma3_1b_buckets_at_the_default_cap():
    """One rank's f32 work buffers of full-width gemma3-1b: the embedding
    (1.2 GB) is a bucket of its own, and no other bucket passes the
    cap."""
    sizes = [4 * int(np.prod(s)) for s in _shapes(reduced=False).values()]
    buckets = plan_buckets(sizes, BUCKET_BYTES)
    assert sum(len(b) for b in buckets) == len(sizes) == 340
    big = [b for b in buckets if sum(sizes[i] for i in b) > BUCKET_BYTES]
    assert all(len(b) == 1 for b in big) and len(big) == 1
    assert [i for b in buckets for i in b] == list(range(340))
