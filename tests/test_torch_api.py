"""The port's public quantization API (piquant_tpu_torch) on the CPU: the
reference's validation contract (the same ValueErrors as the JAX package
for each misuse), stochastic rounding held to the JAX tests' criteria
(tests/test_full_matrix.py: within one code of nearest, unbiased in the
mean), QuantizedTensor, the Context shim, and carrying a JAX
QuantizedTensor across byte for byte."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import piquant_tpu as jpq
import piquant_tpu_torch as tq
from piquant_tpu_torch.convert import quantized_tensor_from_jax
from piquant_tpu_torch.ops.reference import unpack_codes

SEED = 0x9032002


def _x(n, dtype=torch.float32, lo=-4.0, hi=4.0):
    rng = np.random.default_rng(SEED + n)
    return torch.from_numpy(rng.uniform(lo, hi, n)).to(dtype)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# the validation contract: each misuse raises ValueError in both packages
# ---------------------------------------------------------------------------

MISUSE = {
    "quantize_int_input": (
        lambda m, x, k: m.quantize(x.to(torch.int32) if k is None else
                                   x.astype(jnp.int32), 0.1, 0, "uint8")),
    "quantize_float_target": (
        lambda m, x, k: m.quantize(x, 0.1, 0, "f32")),
    "dequantize_float_input": (
        lambda m, x, k: m.dequantize(x, 0.1, 0, "uint8")),
    "dequantize_float_source": (
        lambda m, x, k: m.dequantize(m.quantize(x, 0.1, 0, "uint8"), 0.1, 0,
                                     "f32")),
    "dequantize_int_output": (
        lambda m, x, k: m.dequantize(m.quantize(x, 0.1, 0, "uint8"), 0.1, 0,
                                     "uint8", out_dtype="int8")),
    "dequantize_wrong_numel": (
        lambda m, x, k: m.dequantize(m.quantize(x, 0.1, 0, "uint4"), 0.1, 0,
                                     "uint4", numel=33)),
    "dequantize_add_without_out": (
        lambda m, x, k: m.dequantize(m.quantize(x, 0.1, 0, "uint8"), 0.1, 0,
                                     "uint8", reduce_op="add")),
    "dequantize_unknown_reduce": (
        lambda m, x, k: m.dequantize(m.quantize(x, 0.1, 0, "uint8"), 0.1, 0,
                                     "uint8", reduce_op="mul")),
    "quantize_stochastic_without_rng": (
        lambda m, x, k: m.quantize(x, 0.1, 0, "uint8", "stochastic")),
    "quantize_unknown_round": (
        lambda m, x, k: m.quantize(x, 0.1, 0, "uint8", "up")),
    "requantize_stochastic_without_rng": (
        lambda m, x, k: m.requantize(x, 0.1, 0, "uint8", "stochastic")),
    "requantize_add_without_out": (
        lambda m, x, k: m.requantize(x, 0.1, 0, "uint8", reduce_op="add")),
    "requantize_out_size": (
        lambda m, x, k: m.requantize(x, 0.1, 0, "uint8", reduce_op="add",
                                     out=x[:10])),
    "params_float_target": (
        lambda m, x, k: m.compute_quant_params(x, "bf16")),
    "unknown_dtype": (
        lambda m, x, k: m.quantize(x, 0.1, 0, "uint3")),
}


@pytest.mark.parametrize("case", sorted(MISUSE))
def test_misuse_raises_value_error_in_both(case):
    x = np.random.default_rng(SEED).uniform(-1, 1, 64).astype(np.float32)
    with pytest.raises(ValueError):
        MISUSE[case](jpq, jnp.asarray(x), "jax")
    with pytest.raises(ValueError):
        MISUSE[case](tq, torch.from_numpy(x), None)


@pytest.mark.parametrize("reduce_op", ["set", "add"])
def test_dequantize_result_shape_as_jax(reduce_op):
    """The result takes out's shape when out is given (SET too), and
    `shape` when that is given, as in the JAX package."""
    x = np.random.default_rng(SEED).uniform(-1, 1, 24).astype(np.float32)
    out = np.zeros((4, 6), np.float32)
    for kw in ({"out": out}, {"out": out, "shape": (2, 12)}):
        j = jpq.dequantize(jpq.quantize(jnp.asarray(x), 0.01, 3, "uint8"),
                           0.01, 3, "uint8", reduce_op=reduce_op,
                           **{**kw, "out": jnp.asarray(out)})
        t = tq.dequantize(tq.quantize(torch.from_numpy(x), 0.01, 3, "uint8"),
                          0.01, 3, "uint8", reduce_op=reduce_op,
                          **{**kw, "out": torch.from_numpy(out.copy())})
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_add_needs_out_of_the_result_dtype():
    # in place: an accumulator of another dtype cannot take the result
    x = _x(64)
    q = tq.quantize(x, 0.1, 3, "uint8")
    with pytest.raises(ValueError):
        tq.dequantize(q, 0.1, 3, "uint8", reduce_op="add",
                      out=torch.zeros(64, dtype=torch.float64))
    with pytest.raises(ValueError):
        tq.requantize(x, 0.1, 3, "uint8", reduce_op="add",
                      out=torch.zeros(64, dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# stochastic rounding (the JAX tests' criteria; the bits differ by design)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("qname", ["uint2", "uint4", "int4", "uint8", "int16",
                                   "uint16", "int32", "uint64"])
def test_stochastic_within_one_step(dtype, qname):
    q = tq.DTYPES[qname]
    n = 2048
    x = _x(n, dtype)
    scale, zp = 0.01, (q.qmax + q.qmin) // 2
    if q.bits <= 4:
        scale = 8.0 / (q.qmax - q.qmin)
    qs = tq.quantize(x, scale, zp, qname, "stochastic", generator=_gen(1))
    qn = tq.quantize(x, scale, zp, qname)
    cs = unpack_codes(qs.reshape(-1), n, q).to(torch.int64)
    cn = unpack_codes(qn.reshape(-1), n, q).to(torch.int64)
    assert (cs - cn).abs().max() <= 1
    assert (cs != cn).any()
    # a generator in the same state gives the same codes
    again = tq.quantize(x, scale, zp, qname, "stochastic", generator=_gen(1))
    assert torch.equal(qs.view(torch.uint8), again.view(torch.uint8))


@pytest.mark.parametrize("qname", ["int16", "uint8", "uint32", "int64"])
def test_stochastic_unbiased(qname):
    q = tq.DTYPES[qname]
    n = 100_000
    x = torch.full((n,), 0.777)
    scale, zp = 0.01, (q.qmax + q.qmin) // 2
    packed = tq.quantize(x, scale, zp, qname, "stochastic", generator=_gen(2))
    dq = tq.dequantize(packed, scale, zp, qname, numel=n)
    assert abs(float(dq.mean()) - 0.777) < 2e-4
    fq = tq.requantize(x, scale, zp, qname, "stochastic", generator=_gen(3))
    assert abs(float(fq.mean()) - 0.777) < 2e-4


def test_stochastic_matches_jax_in_distribution():
    """Same input and parameters: the fraction of elements rounded up agrees
    with the JAX package's within sampling noise (n = 100,000: 4 sigma of
    a binomial at p = 0.7 is 0.006)."""
    n = 100_000
    x = np.full(n, 0.777, np.float32)
    j = np.asarray(jpq.quantize(jnp.asarray(x), 0.01, 128, "uint8",
                                "stochastic", key=jax.random.key(5)))
    t = tq.quantize(torch.from_numpy(x), 0.01, 128, "uint8", "stochastic",
                    generator=_gen(5)).numpy()
    assert set(np.unique(j)) == set(np.unique(t)) == {205, 206}
    assert abs((j == 206).mean() - (t == 206).mean()) < 0.006


# ---------------------------------------------------------------------------
# QuantizedTensor, the Context shim, conversion from JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qname", ["uint2", "uint4", "int4", "uint8", "int8",
                                   "uint16", "int32", "uint64"])
def test_quantized_tensor_from_jax_byte_for_byte(qname):
    rng = np.random.default_rng(SEED)
    x = rng.normal(0, 1, (17, 33)).astype(np.float32)
    jqt = jpq.quantize_tensor(jnp.asarray(x), qname)
    tqt = quantized_tensor_from_jax(jqt, device="cpu")
    assert tqt.shape == (17, 33) and tqt.qdtype == qname
    assert tqt.data.dtype == tq.DTYPES[qname].storage
    assert tqt.data.numpy().tobytes() == np.asarray(jqt.data).tobytes()
    assert float(tqt.scale) == float(jqt.scale)
    assert int(tqt.zero_point) == int(jqt.zero_point)
    np.testing.assert_array_equal(tqt.dequantize().numpy(),
                                  np.asarray(jqt.dequantize()))
    # and the port's own quantize_tensor of the same floats: the same bytes
    own = tq.quantize_tensor(torch.from_numpy(x), qname)
    assert own.data.numpy().tobytes() == np.asarray(jqt.data).tobytes()
    np.testing.assert_array_equal(tq.dequantize_tensor(own).numpy(),
                                  np.asarray(jpq.dequantize_tensor(jqt)))


def test_quantized_tensor_given_params_and_add():
    x = _x(1000).reshape(10, 100)
    qt = tq.quantize_tensor(x, "uint4", scale=0.05, zero_point=8)
    assert qt.data.numel() == tq.packed_numel(1000, tq.DTYPES["uint4"])
    acc = torch.ones(10, 100)
    res = qt.dequantize(reduce_op="add", out=acc)
    assert res.data_ptr() == acc.data_ptr()
    torch.testing.assert_close(acc - 1, qt.dequantize(), atol=1e-6, rtol=0)
    assert (qt.dequantize("bf16").dtype, qt.numel) == (torch.bfloat16, 1000)


def test_context_shim_forwards():
    ctx = tq.Context(num_threads=4)
    assert tq.Context.get() is tq.Context.get()
    x = _x(256)
    s, z = ctx.compute_quant_config_from_data(x, "uint8")
    q = ctx.quantize(x, s, z, "uint8")
    assert torch.equal(q, tq.quantize(x, s, z, "uint8"))
    assert torch.equal(ctx.quantize_dequantize_fused(x, s, z, "uint8"),
                       ctx.dequantize(q, s, z, "uint8"))
    assert tq.quantize_dequantize_fused is tq.requantize
    assert tq.RoundMode("stochastic") is tq.RoundMode.STOCHASTIC
    assert tq.ReduceOp.ADD == "add"
