"""The fused DSGD-momentum update of the port on the CPU (its plain
version, ``ref.fused_dsgd_ref``, and the ``ops.fused_dsgd_step`` entry
point) against the reference's ``fused_dsgd_ref`` and its Pallas kernel
in interpret mode, on the same numpy inputs.

Tolerances:
- against the reference's plain version: bit for bit, in f32 and in
  bf16.  Both take the same f32 steps, one op each, in the same order.
- against the Pallas kernel in interpret mode: XLA compiles the kernel
  body as one fused computation on the CPU and contracts ``beta*u + g``
  and ``x - eta*u'`` into fused multiply-adds, so its f32 result drops
  the rounding of those products.  The bound is four f32 roundings
  (4 * 2^-24) of the magnitudes of the terms of each line, which covers
  a skipped product rounding plus the rounding of the result; for x' the
  u' difference carried through ``eta * pre`` is added.  In bf16 one
  bf16 rounding step (2^-7 of the value) is allowed on top, since the
  two f32 results may round to neighbouring bf16 values.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ops import KernelConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused_dsgd import fused_dsgd

PALLAS = KernelConfig(backend="pallas", interpret=True)
BETA, ETA = 0.9, 0.01
F32_ROUNDINGS = 4 * 2.0 ** -24

SHAPES = [(), (7,), (5, 33), (3, 4, 65), (257, 513)]


def _inputs(shape, dtype, pre_mode, seed):
    rng = np.random.default_rng(seed)
    x, u, g = (rng.standard_normal(shape, dtype=np.float32)
               for _ in range(3))
    if pre_mode == "row":
        pre = rng.uniform(0.2, 1.0, size=shape[:1]).astype(np.float32)
    else:
        pre = {"one": 1.0, "scalar": 0.37}[pre_mode]
    if dtype == "bfloat16":   # both sides get the same bf16 bits
        x, u, g = (a.astype(ml_dtypes.bfloat16) for a in (x, u, g))
    return x, u, g, pre


def _jax(a):
    return a if isinstance(a, float) else jnp.asarray(a)


def _torch(a):
    if isinstance(a, float):
        return a
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(a):
    """The bit pattern of an f32 / bf16 array (torch or jax)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy().view(np.int32)
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype == ml_dtypes.bfloat16 else np.int32)


def _f32(a):
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


def _cases():
    for shape in SHAPES:
        for pre_mode in ("one", "scalar", "row"):
            if pre_mode == "row" and not shape:
                continue
            for dtype in ("float32", "bfloat16"):
                yield shape, pre_mode, dtype


CASES = list(_cases())
IDS = [f"{'x'.join(map(str, s)) or 'scalar'}-{p}-{d}" for s, p, d in CASES]


def _port_both(x, u, g, pre):
    """The port's plain version and its entry point on the CPU; they must
    be the same call."""
    tx, tu, tg, tp = (_torch(a) for a in (x, u, g, pre))
    per_row = isinstance(tp, torch.Tensor)
    bp = tp.reshape((-1,) + (1,) * (tx.ndim - 1)) if per_row else tp
    want = ref.fused_dsgd_ref(tx, tu, tg, BETA, ETA, bp)
    got = ops.fused_dsgd_step(tx, tu, tg, BETA, ETA, tp)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(_bits(a), _bits(b))
    return got


@pytest.mark.parametrize("shape,pre_mode,dtype", CASES, ids=IDS)
def test_matches_reference_plain_version_bitwise(shape, pre_mode, dtype):
    x, u, g, pre = _inputs(shape, dtype, pre_mode, seed=len(shape))
    tx, tu = _port_both(x, u, g, pre)
    jp = _jax(pre)
    if isinstance(pre, np.ndarray):       # per node: (n, 1, ..., 1)
        jp = jp.reshape((-1,) + (1,) * (len(shape) - 1))
    jx, ju = jref.fused_dsgd_ref(_jax(x), _jax(u), _jax(g), BETA, ETA, jp)
    assert tx.shape == jx.shape
    assert np.array_equal(_bits(tx), _bits(jx))
    assert np.array_equal(_bits(tu), _bits(ju))


@pytest.mark.parametrize("shape,pre_mode,dtype", CASES, ids=IDS)
def test_matches_reference_pallas_interpret(shape, pre_mode, dtype):
    x, u, g, pre = _inputs(shape, dtype, pre_mode, seed=10 + len(shape))
    tx, tu = _port_both(x, u, g, pre)
    jx, ju = jops.fused_dsgd_step(_jax(x), _jax(u), _jax(g), BETA, ETA,
                                  _jax(pre), config=PALLAS)
    xf, uf, gf = (np.asarray(a, np.float32) for a in (x, u, g))
    p = np.asarray(pre, np.float32)
    if p.ndim:
        p = p.reshape((-1,) + (1,) * (len(shape) - 1))
    u_new = _f32(tu)
    tol_u = F32_ROUNDINGS * (np.abs(BETA * uf) + np.abs(gf))
    tol_x = np.abs(p) * (F32_ROUNDINGS * (np.abs(xf) + np.abs(ETA * u_new))
                         + ETA * tol_u)
    if dtype == "bfloat16":
        tol_u = tol_u + 2.0 ** -7 * np.abs(_f32(ju))
        tol_x = tol_x + 2.0 ** -7 * np.abs(_f32(jx))
    assert np.all(np.abs(u_new - _f32(ju)) <= tol_u)
    assert np.all(np.abs(_f32(tx) - _f32(jx)) <= tol_x)


def test_cpu_step_leaves_the_kernel_counter_alone():
    x = torch.randn(3, 5)
    before = fused_dsgd.launches
    ops.fused_dsgd_step(x, x, x, BETA, ETA, torch.ones(3))
    ops.fused_dsgd_step(x, x, x, BETA, ETA)
    assert fused_dsgd.launches == before


def test_kernel_wrapper_takes_cuda_tensors_only():
    x = torch.randn(3, 5)
    with pytest.raises(ValueError, match="CUDA"):
        fused_dsgd(x, x, x, BETA, ETA)


@pytest.mark.parametrize("shape,lead_rows,want", [
    ((), False, (1, 1)), ((), True, (1, 1)), ((7,), False, (1, 7)),
    ((7,), True, (7, 1)), ((5, 33), False, (5, 33)),
    ((5, 33), True, (5, 33)), ((3, 4, 65), False, (12, 65)),
    ((3, 4, 65), True, (3, 260)),
])
def test_as_2d_matches_reference(shape, lead_rows, want):
    a = np.zeros(shape, np.float32)
    j2, jshape = jops._as_2d(jnp.asarray(a), lead_rows=lead_rows)
    t2, tshape = ops._as_2d(torch.from_numpy(a), lead_rows=lead_rows)
    assert tuple(t2.shape) == tuple(j2.shape) == want
    assert tuple(tshape) == tuple(jshape) == shape
