"""The port's library core (piquant_tpu_torch ops) against the JAX package on
the CPU: the same numpy inputs through the JAX reference (ops/reference.py),
the Pallas kernels in interpret mode, and the port, whose kernel wrappers
run their plain PyTorch versions on CPU tensors.

Tolerances: against the JAX reference everything is bit for bit: codes,
packed bytes, dequantize / requantize outputs (f32 and bf16, SET and ADD)
and (scale, zero point).  Against the Pallas kernels, codes, bytes and the
SET outputs are bit for bit too; their ADD is not, for two reasons the
kernels own: under interpret mode XLA contracts acc + diff * scale into one
FMA (f32 ADD within 1e-6, the bound tests/test_pallas_interpret.py holds
the kernels to), and the bf16 kernels add in f32 and round once where the
reference rounds the addend to bf16 first (half a bf16 ulp of |addend| <= 8
plus one rounding of the sum: atol 2^-5, rtol 2^-7).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from piquant_tpu import dtypes as jdt
from piquant_tpu.ops import reference as jref
from piquant_tpu.ops.pallas import dequantize as jpdq
from piquant_tpu.ops.pallas import minmax as jpmm
from piquant_tpu.ops.pallas import quantize as jpq
from piquant_tpu.ops.pallas import requantize as jprq
import piquant_tpu_torch as tq
from piquant_tpu_torch import dtypes as tdt
from piquant_tpu_torch.convert import tensor_from_numpy
from piquant_tpu_torch.ops import reference as tref

JDT = jdt.DTYPES
SEED = 0x9032002
N_ALIGNED = 8 * 128 * 4          # the sizes of tests/test_pallas_interpret.py
N_TAIL = 8 * 128 * 4 + 77
KERNEL_CODES = ["uint8", "int8", "uint16", "int16", "uint4", "int4", "uint2"]
FLOATS = ["f32", "f64", "bf16"]
ALL_QUANTS = ["uint2", "uint4", "int4", "uint8", "int8", "uint16", "int16",
              "uint32", "int32", "uint64", "int64"]
# ties, the f32 add that rounds 0.49999997 + 0.5 up to 1, NaN, +-inf,
# values past int32, a denormal and -0
EDGE = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.49999997, -0.49999997,
                 np.nan, np.inf, -np.inf, 3e9, -3e9, 1e-45, -0.0, 7.5, -7.5,
                 128.5, -128.5], np.float32)


def _t(a):
    return tensor_from_numpy(a, torch.device("cpu"))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _x(n, fname, lo=-4.0, hi=4.0):
    """(jax array, torch tensor) holding the same n floats."""
    rng = np.random.default_rng(SEED + n)
    j = jnp.asarray(rng.uniform(lo, hi, n), JDT[fname].storage)
    return j, _t(np.asarray(j))


def _same(got: torch.Tensor, want) -> None:
    """Bit for bit (NaN equal to NaN), values compared as float64/int."""
    w = np.asarray(want)
    g = _np(got)
    assert g.shape == w.shape
    if np.issubdtype(w.dtype, np.integer):
        np.testing.assert_array_equal(g.astype(np.int64) if g.dtype != np.uint64
                                      else g, w.astype(g.dtype))
    else:
        np.testing.assert_array_equal(g.astype(np.float64),
                                      w.astype(np.float64))


def _close_to_pallas(got: torch.Tensor, want, reduce_op: str) -> None:
    if reduce_op == "set":
        _same(got, want)
        return
    bf16 = got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), _t(np.asarray(want, np.float32)),
                               atol=2 ** -5 if bf16 else 1e-6,
                               rtol=2 ** -7 if bf16 else 0)


def test_registry_matches_reference():
    assert sorted(tdt.DTYPES) == sorted(JDT)
    for name, j in JDT.items():
        t = tdt.DTYPES[name]
        assert (t.bits, t.kind, t.is_packed, t.pack_factor, t.stride,
                t.is_signed, t.is_float) == (
            j.bits, j.kind, j.is_packed, j.pack_factor, j.stride,
            j.is_signed, j.is_float)
        assert str(t.storage).removeprefix("torch.") == j.storage.name
        if j.is_quant:
            assert (t.qmin, t.qmax) == (j.qmin, j.qmax)
            for n in (1, 3, 5, 8, 4099):
                assert tdt.packed_numel(n, t) == jdt.packed_numel(n, j)
                assert tdt.tail_mask(n, t) == jdt.tail_mask(n, j)
    assert tdt.dtype_of(torch.bfloat16) is tdt.bf16
    assert tdt.dtype_of(torch.uint16) is tdt.uint16
    for bad in ("uint3", torch.float16):
        with pytest.raises(ValueError):
            tdt.dtype_of(bad)


def test_uniform_hash_matches_numpy_uint32():
    """The hash the CUDA kernels compute (csrc/pq_quant.cuh), in numpy's
    wrapping uint32 arithmetic."""
    def mix32(x):
        with np.errstate(over="ignore"):
            x = x ^ (x >> np.uint32(16))
            x = x * np.uint32(0x7FEB352D)
            x = x ^ (x >> np.uint32(15))
            x = x * np.uint32(0x846CA68B)
            return x ^ (x >> np.uint32(16))

    rng = np.random.default_rng(SEED)
    v = rng.integers(0, 2**32, 10000, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        tref._mix32(torch.from_numpy(v.astype(np.int64))).numpy(),
        mix32(v).astype(np.int64))
    seed = 0xDEADBEEF12345678
    i = np.arange(5000, dtype=np.uint32)
    with np.errstate(over="ignore"):
        h = mix32(mix32(i ^ np.uint32(seed & 0xFFFFFFFF))
                  + np.uint32(seed >> 32))
    want = (h >> np.uint32(9)).astype(np.float32) / np.float32(2 ** 23)
    np.testing.assert_array_equal(tref.uniform(seed, 5000, "cpu").numpy(), want)


# ---------------------------------------------------------------------------
# quantize: bit-exact against the reference and the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fname", ["f32", "bf16"])
@pytest.mark.parametrize("qname", KERNEL_CODES)
@pytest.mark.parametrize("n", [N_ALIGNED, N_TAIL])
def test_quantize_bit_exact(fname, qname, n):
    jx, tx = _x(n, fname)
    s, z = 0.031, 7
    got = tq.quantize(tx, s, z, qname)
    _same(got.reshape(-1), jref.quantize(jx, s, z, JDT[qname], "nearest"))
    with pltpu.force_tpu_interpret_mode():
        want = jpq.quantize(jx, s, z, JDT[qname], "nearest")
    _same(got.reshape(-1), want)
    assert got.dtype == tdt.DTYPES[qname].storage


@pytest.mark.parametrize("fname", ["f32", "bf16"])
@pytest.mark.parametrize("qname", KERNEL_CODES)
def test_quantize_edge_vector(fname, qname):
    jx = jnp.asarray(EDGE, JDT[fname].storage)
    tx = _t(np.asarray(jx))
    for s, z in ((1.0, 7), (1.0, -5), (1.0, 0), (0.25, 3)):
        got = tq.quantize(tx, s, z, qname).reshape(-1)
        _same(got, jref.quantize(jx, s, z, JDT[qname], "nearest"))
        with pltpu.force_tpu_interpret_mode():
            _same(got, jpq.quantize(jx, s, z, JDT[qname], "nearest"))


def test_quantize_edge_values_spelled_out():
    # +inf saturates to INT32_MAX, and + zp wraps it negative: qmin; NaN
    # casts to 0, so it lands on zp; 0.49999997 + 0.5 rounds up in f32
    x = torch.tensor([np.inf, np.nan, 0.49999997, -np.inf, 3e9])
    assert tq.quantize(x, 1.0, 7, "uint8").tolist() == [0, 7, 8, 0, 0]
    assert tq.quantize(x, 1.0, 7, "int8").tolist() == [-128, 7, 8, -128, -128]
    assert tq.quantize(x, 1.0, 0, "uint8").tolist() == [255, 0, 1, 0, 255]


def test_quantize_device_scale_and_zero_point():
    """Tensor scale / zero point (as compute_quant_params returns them) give
    the same codes as the host numbers."""
    jx, tx = _x(N_TAIL, "f32")
    s, z = tq.compute_quant_params(tx, "uint4")
    got = tq.quantize(tx, s, z, "uint4")
    _same(got, jref.quantize(jx, float(s), int(z), JDT["uint4"], "nearest"))


# ---------------------------------------------------------------------------
# dequantize / requantize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qname", KERNEL_CODES)
@pytest.mark.parametrize("oname", ["f32", "bf16"])
@pytest.mark.parametrize("reduce_op", ["set", "add"])
def test_dequantize_matches(qname, oname, reduce_op):
    n = N_TAIL
    dt = JDT[qname]
    jx, _ = _x(n, "f32")
    s, z = 0.05, dt.qmax // 2
    jq = jref.quantize(jx, s, z, dt, "nearest")
    tqc = _t(np.asarray(jq))
    odt = JDT[oname].storage
    jout = jnp.asarray(np.linspace(-3, 3, n), odt) if reduce_op == "add" else None
    tout = _t(np.asarray(jout)) if reduce_op == "add" else None
    got = tq.dequantize(tqc, s, z, qname, out_dtype=oname, numel=n,
                        reduce_op=reduce_op, out=tout)
    if reduce_op == "add":
        assert got is tout            # in place
    _same(got, jref.dequantize(jq, n, s, z, dt, JDT[oname], reduce_op, jout))
    with pltpu.force_tpu_interpret_mode():
        want = jpdq.dequantize(jq, n, s, z, dt, JDT[oname], reduce_op, jout)
    _close_to_pallas(got, want, reduce_op)


@pytest.mark.parametrize("fname", ["f32", "bf16"])
@pytest.mark.parametrize("qname", KERNEL_CODES)
@pytest.mark.parametrize("reduce_op", ["set", "add"])
def test_requantize_matches(fname, qname, reduce_op):
    n = N_TAIL
    dt = JDT[qname]
    jx, tx = _x(n, fname)
    s, z = 0.6 / (dt.qmax - dt.qmin) * 8, (dt.qmax + dt.qmin) // 2 + 1
    jout = jnp.full((n,), 1.25, jx.dtype) if reduce_op == "add" else None
    tout = _t(np.asarray(jout)) if reduce_op == "add" else None
    got = tq.requantize(tx, s, z, qname, reduce_op=reduce_op, out=tout)
    _same(got, jref.requantize(jx, s, z, dt, "nearest", reduce_op, jout))
    with pltpu.force_tpu_interpret_mode():
        want = jprq.requantize(jx, s, z, dt, "nearest", reduce_op, jout)
    _close_to_pallas(got, want, reduce_op)


def test_dequantize_add_into_strided_out():
    """ADD into a non-contiguous accumulator still lands in place."""
    n = 300
    jx, tx = _x(n, "f32")
    q = tq.quantize(tx, 0.03, 3, "int4")
    base = torch.ones(n, 2)
    out = base[:, 1]
    res = tq.dequantize(q, 0.03, 3, "int4", numel=n, reduce_op="add", out=out)
    want = 1 + jref.dequantize(jnp.asarray(q.numpy()), n, 0.03, 3,
                               JDT["int4"])
    _same(base[:, 1], want)
    assert res.data_ptr() == out.data_ptr()
    assert (base[:, 0] == 1).all()


# ---------------------------------------------------------------------------
# compute_quant_params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "ragged", "degenerate", "nan",
                                  "bf16", "f64"])
@pytest.mark.parametrize("qname", ["uint8", "int8", "uint4", "int16", "uint32",
                                   "int64"])
def test_compute_quant_params(case, qname):
    fname = {"bf16": "bf16", "f64": "f64"}.get(case, "f32")
    n = {"ragged": 1024 * 128 * 2 + 777}.get(case, 4099)
    jx, tx = _x(n, fname, -3.1, 5.7)
    if case == "degenerate":
        jx, tx = jnp.full((n,), 0.3, jnp.float32), torch.full((n,), 0.3)
    if case == "nan":
        a = np.asarray(jx).copy()
        a[n // 3] = np.nan
        jx, tx = jnp.asarray(a), _t(a)
    s, z = tq.compute_quant_params(tx, qname)
    assert s.dtype == torch.float32 and z.dtype == torch.int32 and s.dim() == 0
    js, jz = jref.compute_quant_params(jx, JDT[qname])
    _same(s, js)
    _same(z, jz)
    if fname != "f64":
        with pltpu.force_tpu_interpret_mode():
            ps, pz = jpmm.compute_quant_params(jx, JDT[qname])
        _same(s, ps)
        _same(z, pz)


# ---------------------------------------------------------------------------
# the full dtype matrix through the API (kernel combinations and the plain
# path for f64 and the 32/64-bit codes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fname", FLOATS)
@pytest.mark.parametrize("qname", ALL_QUANTS)
def test_full_matrix_bit_exact(fname, qname):
    import piquant_tpu as jpq_api

    q = JDT[qname]
    n = 4099
    jx, tx = _x(n, fname)
    if q.bits <= 8:
        js, jz = jpq_api.compute_quant_params(jx, q)
        ts, tz = tq.compute_quant_params(tx, qname)
        _same(ts, js)
        _same(tz, jz)
        s, z = float(js), int(jz)
    else:
        s, z = 0.001, (q.qmax + q.qmin) // 2
    jcodes = jpq_api.quantize(jx, s, z, q)
    tcodes = tq.quantize(tx, s, z, qname)
    _same(tcodes, jcodes)
    oname = fname if fname != "bf16" else "f32"
    jd = jpq_api.dequantize(jcodes, s, z, q, out_dtype=oname, numel=n)
    td = tq.dequantize(tcodes, s, z, qname, out_dtype=oname, numel=n)
    _same(td, jd)
    _same(tq.requantize(tx, s, z, qname), jpq_api.requantize(jx, s, z, q))
    acc = tx.clone()
    jr = jpq_api.requantize(jx, s, z, q, reduce_op="add", out=jx)
    assert tq.requantize(tx, s, z, qname, reduce_op="add", out=acc) is acc
    _same(acc, jr)
