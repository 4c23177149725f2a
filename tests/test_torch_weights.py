"""The port's weight formats (INT2 / INT4 / INT8, channelwise and grouped)
against the JAX package on the CPU: the quantized weights byte for byte,
the wire converters, each new GEMV kernel's plain version against its
Pallas kernel in interpret mode, and which kernel each dispatch gate
picks."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from piquant_tpu.ops.pallas import qmatmul as JQ
from piquant_tpu.quant import linear as JL
from piquant_tpu_torch.convert import params_from_jax, tensor_from_numpy
from piquant_tpu_torch.ops.cuda import qmatmul as TQ
from piquant_tpu_torch.quant import linear as TL

SEED = 0x3E16
WRAPPERS = ("w4_gemv", "w8_gemv", "w2_gemv", "wg_chunk", "w4_grouped")


def _t(a):
    return tensor_from_numpy(a, torch.device("cpu"))


def _bits_of(t):
    """A tensor's bytes as numpy (bf16 through its int16 view)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _np_bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same_linear(tq, jq):
    assert (tq.bits, tq.k, tq.group_size) == (jq.bits, jq.k, jq.group_size)
    for f in ("data", "scale", "zero_point", "s_chunk", "z_chunk"):
        j, t = getattr(jq, f), getattr(tq, f)
        if j is None:
            assert t is None, f
            continue
        np.testing.assert_array_equal(_bits_of(t), _np_bits(j), err_msg=f)


@pytest.fixture
def counted(monkeypatch):
    """Count each wrapper's calls on the CPU, where it runs its plain
    version (the kernels count only their launches on the card)."""
    calls = dict.fromkeys(WRAPPERS, 0)
    for name in WRAPPERS:
        plain = getattr(TQ, name + "_plain")

        def bump(*a, _name=name, _plain=plain, **k):
            calls[_name] += 1
            return _plain(*a, **k)

        monkeypatch.setattr(TQ, name + "_plain", bump)
    return calls


# Byte for byte: the same f32 derivation op for op; grouped INT2/INT4 scales
# rounded to bf16 before the zero point, and the chunk-major side streams.
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("gs", [None, 32, 64])
def test_quantize_linear_weight_byte_equal(bits, gs):
    rng = np.random.default_rng(SEED + bits)
    w = rng.normal(0, 0.05, (1024, 256)).astype(np.float32)
    w[:, 7] = 0.25                          # a constant column: span == 0
    w[:64, 9] = -0.125                      # a constant group
    jq = JL.quantize_linear_weight(jnp.asarray(w), bits, group_size=gs)
    tq = TL.quantize_linear_weight(_t(w), bits, group_size=gs)
    _same_linear(tq, jq)
    if gs is not None and bits != 8:
        assert tq.s_chunk is not None and tq.s_chunk.dtype == torch.bfloat16
    unpack = {2: JL.unpack_split_quarter, 4: JL.unpack_split_half,
              8: lambda d: d.astype(jnp.int32)}[bits]
    np.testing.assert_array_equal(tq.codes().numpy(),
                                  np.asarray(unpack(jq.data)))
    np.testing.assert_array_equal(tq.dequantize(torch.float32).numpy(),
                                  np.asarray(jq.dequantize(jnp.float32)))
    assert TL.quantize_linear_weight(_t(w), bits, channelwise=False,
                                     group_size=gs).data.shape == tq.data.shape


def test_quantize_linear_weight_refuses():
    w = torch.zeros(64, 32)
    # NF4 (tests/test_torch_nf4.py) builds; stochastic rounding needs its
    # generator
    assert TL.quantize_linear_weight(w, "nf4").codebook == "nf4"
    with pytest.raises(ValueError):
        TL.quantize_linear_weight(w, 4, stochastic=True)
    with pytest.raises(ValueError):
        TL.quantize_linear_weight(w, 3)
    with pytest.raises(ValueError):
        TL.quantize_linear_weight(w, 4, group_size=48)


@pytest.mark.parametrize("bits,gs", [(2, None), (2, 16), (4, None), (4, 16),
                                     (8, None)])
def test_wire_roundtrip_matches_jax(bits, gs):
    """to_wire gives the JAX package's wire bytes; from_wire of them gives
    its QuantizedLinear, side streams included."""
    rng = np.random.default_rng(SEED + 21)
    k, n = 256, 32
    w = rng.normal(0, 0.05, (k, n)).astype(np.float32)
    jq = JL.quantize_linear_weight(jnp.asarray(w), bits, group_size=gs)
    tq = TL.quantize_linear_weight(_t(w), bits, group_size=gs)
    wire = tq.to_wire()
    np.testing.assert_array_equal(wire.numpy(), np.asarray(jq.to_wire()))
    back = TL.QuantizedLinear.from_wire(_t(np.asarray(jq.to_wire())),
                                        tq.scale, tq.zero_point, bits, k, n,
                                        gs)
    jback = JL.QuantizedLinear.from_wire(jq.to_wire(), jq.scale,
                                         jq.zero_point, bits, k, n, gs)
    _same_linear(back, jback)
    _same_linear(back, jq)


def test_grouped_chunk_order_matches_jax():
    for k, gs, planes in ((1024, 32, 4), (2048, 64, 2), (14336, 128, 2),
                          (14336, 32, 4), (4096, 256, 2)):
        ch = TL.grouped_chunk_factor(k, gs, planes)
        assert ch == JL.grouped_chunk_factor(k, gs, planes)
        np.testing.assert_array_equal(TL.grouped_chunk_perm(k, gs, ch, planes),
                                      JL.grouped_chunk_perm(k, gs, ch, planes))
    assert TL.grouped_chunk_factor(14336, 256, 2) is None      # 28 a plane


def _pallas(x, jq):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(JQ.quantized_matmul(jnp.asarray(x), jq, jnp.float32))


def _both(bits, k, n, gs, m, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.05, (k, n)).astype(np.float32)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    jq = JL.quantize_linear_weight(jnp.asarray(w), bits, group_size=gs)
    tq = TL.quantize_linear_weight(_t(w), bits, group_size=gs)
    return x, jq, tq


# The chunk kernel's plain version against `_wg_chunk_kernel` at the shapes
# of tests/test_qmatmul.py's chunk-kernel test, within its bound (atol 2e-2,
# rtol 2e-2): per-group f32 products summed in another order.
@pytest.mark.parametrize("bits,k,gs,m", [(2, 512, 32, 8), (2, 1024, 32, 1),
                                         (2, 2048, 64, 8), (2, 1024, 32, 33),
                                         (4, 512, 32, 8), (4, 1024, 32, 16),
                                         (4, 2048, 64, 8)])
def test_wg_chunk_matches_pallas(counted, bits, k, gs, m):
    x, jq, tq = _both(bits, k, 256, gs, m, SEED + 11)
    want = _pallas(x, jq)
    got = TL.quantized_matmul(_t(x), tq, torch.float32).numpy()
    assert counted["wg_chunk"] == 1 and sum(counted.values()) == 1
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


# `_w4_grouped_kernel` (gs 16: under the chunk kernel's 32 quantum) and the
# channelwise `_w8_kernel` / `_w2_kernel`: atol 2e-2, rtol 1e-2, the
# quantized_matmul bound of the JAX tests.
@pytest.mark.parametrize("bits,k,gs,kernel", [(4, 512, 16, "w4_grouped"),
                                              (8, 512, None, "w8_gemv"),
                                              (8, 1024, None, "w8_gemv"),
                                              (2, 512, None, "w2_gemv"),
                                              (2, 1024, None, "w2_gemv")])
@pytest.mark.parametrize("m", [1, 8, 33])
def test_gemv_matches_pallas(counted, bits, k, gs, kernel, m):
    x, jq, tq = _both(bits, k, 384, gs, m, SEED + bits + k + m)
    want = _pallas(x, jq)
    got = TL.quantized_matmul(_t(x), tq, torch.float32).numpy()
    assert counted[kernel] == 1 and sum(counted.values()) == 1
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=1e-2)


# (bits, K, N, group size, M) -> the wrapper the dispatch gates pick, None
# where the reference dispatch has no kernel either
ROUTES = [
    ((4, 512, 256, None, 8), "w4_gemv"),
    ((8, 512, 256, None, 8), "w8_gemv"),
    ((8, 512, 256, None, 65), None),           # M > 64
    ((2, 512, 256, None, 8), "w2_gemv"),
    ((2, 256, 256, None, 8), None),            # INT2 needs K % 512
    ((4, 512, 200, None, 8), None),            # N % 128
    ((4, 1024, 256, 32, 8), "wg_chunk"),
    ((2, 1024, 256, 32, 8), "wg_chunk"),
    ((4, 1024, 256, 64, 64), "wg_chunk"),
    ((4, 512, 256, 16, 8), "w4_grouped"),      # gs % 32: the chunk declines
    ((4, 3584, 128, 256, 8), "w4_grouped"),    # 7 groups a plane: no factor
    ((2, 512, 256, 16, 8), None),              # grouped INT2 the chunk declines
    ((4, 768, 256, 256, 8), None),             # groups straddle the planes
    ((8, 1024, 256, 32, 8), None),             # grouped INT8
]


@pytest.mark.parametrize("shape,kernel", ROUTES, ids=[str(r[0]) for r in ROUTES])
def test_quantized_matmul_routes_formats(counted, shape, kernel):
    bits, k, n, gs, m = shape
    x, _, tq = _both(bits, k, n, gs, m, SEED + 5)
    got = TQ.quantized_matmul(_t(x), tq, torch.float32)
    assert (got is None) == (kernel is None)
    want = {kernel: 1} if kernel else {}
    assert {w: c for w, c in counted.items() if c} == want
    # every route computes the same function as the dequant path
    y = TL.quantized_matmul(_t(x), tq, torch.float32)
    ref = TL._matmul_dequant(_t(x), tq, torch.float32)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("bits", [2, 4])
def test_grouped_prefill_dense_route(bits):
    """Grouped weights at M >= 256 run one dense product against the bf16
    dequantized weight (the reference's accelerator route): within the JAX
    package's dequant path's result."""
    x, jq, tq = _both(bits, 1024, 256, 32, 256, SEED + 7)
    want = np.asarray(JL.quantized_matmul(jnp.asarray(x), jq, jnp.float32))
    got = TL.quantized_matmul(_t(x), tq, torch.float32)
    dense = TL.dot_f32(_t(x).to(torch.bfloat16), tq.dequantize(torch.bfloat16))
    np.testing.assert_array_equal(got.numpy(), dense.numpy())
    np.testing.assert_allclose(got.numpy(), want, atol=5e-2, rtol=2e-2)


@pytest.mark.parametrize("bits,gs", [(2, None), (2, 32), (4, 32), (8, None)])
def test_params_from_jax_carries_formats(bits, gs):
    """convert carries INT2 / grouped / INT8 weights byte for byte, side
    streams included."""
    _, jq, _ = _both(bits, 1024, 256, gs, 1, SEED + 9)
    tq = params_from_jax({"w": jq}, device="cpu")["w"]
    _same_linear(tq, jq)
