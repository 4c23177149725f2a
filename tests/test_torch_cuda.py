"""The port's CUDA kernels against their plain PyTorch versions, on the GPU,
at shapes beyond the main path (several row tiles, every GQA rep the
kernels take, ragged T; for the library core: tails, misaligned slices, ADD
into views, device-resident scales) and for the inputs the kernels refuse.

These tests need a CUDA card and skip elsewhere.  On a GPU machine without
JAX (this file imports none of it), run them without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from piquant_tpu_torch.dtypes import DTYPES
from piquant_tpu_torch.ops.cuda import decode_attn2 as DA
from piquant_tpu_torch.ops.cuda import dequantize as DQ
from piquant_tpu_torch.ops.cuda import minmax as MM
from piquant_tpu_torch.ops.cuda import quantize as QK
from piquant_tpu_torch.ops.cuda import requantize as RQ
from piquant_tpu_torch.ops.cuda import flash as FL
from piquant_tpu_torch.ops.cuda import qmatmul as Q
from piquant_tpu_torch.quant.linear import QuantizedLinear

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


# bf16 outputs: atol 2e-2 + rtol 1e-2 (the quantized_matmul bound of the
# JAX tests, which also covers one bf16 rounding of an O(1) output)
@pytest.mark.parametrize("m,k,n", [(1, 256, 512), (8, 4096, 1024),
                                   (33, 512, 384), (64, 8704, 1024)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_w4_gemv_matches_plain(dev, m, k, n, out_dtype):
    g = _gen(dev, m + k)
    data = torch.randint(0, 256, (k // 2, n), generator=g, device=dev,
                         dtype=torch.uint8)
    scale = torch.rand(n, generator=g, device=dev) * 0.02 + 0.01
    zp = torch.randint(0, 16, (n,), generator=g, device=dev, dtype=torch.int32)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    xsum = x.float().sum(1, keepdim=True)
    before = Q.w4_gemv.launches
    got = Q.w4_gemv(x, data, scale, zp, xsum, out_dtype).float()
    assert Q.w4_gemv.launches == before + 1
    want = Q.w4_gemv_plain(x, data, scale, zp, xsum, out_dtype).float()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=1e-2)


def test_w4_gemv_refuses(dev):
    x = torch.zeros((65, 256), dtype=torch.bfloat16, device=dev)
    data = torch.zeros((128, 128), dtype=torch.uint8, device=dev)
    f = torch.zeros(128, device=dev)
    z = torch.zeros(128, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        Q.w4_gemv(x, data, f, z, x.float().sum(1, keepdim=True), torch.bfloat16)
    with pytest.raises(TypeError):
        Q.w4_gemv(x[:8].float(), data, f, z, torch.zeros(8, 1, device=dev),
                  torch.bfloat16)
    # an INT8 weight at decode M reaches the reference's _w8_kernel: on the
    # card its port launches
    w8 = QuantizedLinear(data=torch.zeros((256, 128), dtype=torch.uint8,
                                          device=dev),
                         scale=f[None], zero_point=z[None], bits=8, k=256)
    before = Q.w8_gemv.launches
    y = Q.quantized_matmul(x[:8], w8)
    assert Q.w8_gemv.launches == before + 1 and y.shape == (8, 128)


def _qlin(dev, k, n, bits, gs, seed):
    """The port's quantize_linear_weight of a N(0, 0.05) weight, on the
    card (grouped INT2/INT4 with its chunk-major side streams)."""
    from piquant_tpu_torch.quant.linear import quantize_linear_weight

    w = torch.randn((k, n), generator=_gen(dev, seed), device=dev) * 0.05
    return quantize_linear_weight(w, bits, group_size=gs)


def _x(dev, m, k, seed):
    return torch.randn((m, k), generator=_gen(dev, seed),
                       device=dev).to(torch.bfloat16)


# Element by element within atol 2e-2, rtol 1e-2 (the quantized_matmul
# bound of the JAX tests): the f32 sums run in another order, and a bf16
# output may round the other way once.
@pytest.mark.parametrize("m", [1, 8, 33, 64])
@pytest.mark.parametrize("bits,k,n", [(8, 512, 384), (8, 4096, 128256),
                                      (2, 512, 384), (2, 4096, 1024),
                                      (2, 14336, 4096)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_channel_gemv_matches_plain(dev, m, bits, k, n, out_dtype):
    ql = _qlin(dev, k, n, bits, None, k + n)
    x = _x(dev, m, k, m)
    xsum = x.float().sum(1, keepdim=True)
    s, z = ql.scale.reshape(-1).contiguous(), ql.zero_point.reshape(-1).contiguous()
    kern, plain = ((Q.w8_gemv, Q.w8_gemv_plain) if bits == 8
                   else (Q.w2_gemv, Q.w2_gemv_plain))
    before = kern.launches
    got = kern(x, ql.data, s, z, xsum, out_dtype).float()
    assert kern.launches == before + 1
    want = plain(x, ql.data, s, z, xsum, out_dtype).float()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=1e-2)


@pytest.mark.parametrize("m", [1, 8, 33, 64])
@pytest.mark.parametrize("bits,k,n,gs", [(4, 512, 256, 32), (4, 4096, 1024, 128),
                                         (4, 14336, 4096, 128),
                                         (4, 4096, 4096, 256),
                                         (2, 1024, 256, 32), (2, 4096, 1024, 32),
                                         (2, 14336, 4096, 32),
                                         (2, 2048, 384, 64)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_wg_chunk_matches_plain(dev, m, bits, k, n, gs, out_dtype):
    from piquant_tpu_torch.quant.linear import grouped_chunk_factor

    ql = _qlin(dev, k, n, bits, gs, k + gs)
    ch = grouped_chunk_factor(k, gs, Q.PLANES[bits])
    x = _x(dev, m, k, m + 1)
    before = Q.wg_chunk.launches
    got = Q.wg_chunk(x, ql.data, ql.s_chunk, ql.z_chunk, gs, ch,
                     out_dtype).float()
    assert Q.wg_chunk.launches == before + 1
    want = Q.wg_chunk_plain(x, ql.data, ql.s_chunk, ql.z_chunk, gs, ch,
                            out_dtype).float()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=1e-2)


@pytest.mark.parametrize("m", [1, 8, 33, 64])
@pytest.mark.parametrize("k,n,gs", [(512, 256, 16), (1024, 384, 64),
                                    (14336, 4096, 256)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_w4_grouped_matches_plain(dev, m, k, n, gs, out_dtype):
    ql = _qlin(dev, k, n, 4, gs, k + gs + 1)
    x = _x(dev, m, k, m + 2)
    before = Q.w4_grouped.launches
    got = Q.w4_grouped(x, ql.data, ql.scale, ql.zero_point, gs,
                       out_dtype).float()
    assert Q.w4_grouped.launches == before + 1
    want = Q.w4_grouped_plain(x, ql.data, ql.scale, ql.zero_point, gs,
                              out_dtype).float()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=1e-2)


# NF4: the same bound (bf16 table values in both; f32 sums in another
# order).  Channelwise and grouped (the Llama-3-8B shapes at g64 / g128, a
# group of 8 and a K split into many blocks), every M of the GEMV range.
@pytest.mark.parametrize("m", [1, 8, 33, 64])
@pytest.mark.parametrize("k,n,gs", [(512, 256, None), (4096, 1024, None),
                                    (14336, 4096, None), (4096, 14336, 64),
                                    (14336, 4096, 128), (512, 384, 8),
                                    (4096, 4096, 256)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_nf4_gemv_matches_plain(dev, m, k, n, gs, out_dtype):
    ql = _qlin(dev, k, n, "nf4", gs, k + n + (gs or 0))
    x = _x(dev, m, k, m + 3)
    scale = (ql.scale if gs else ql.scale.reshape(-1)).contiguous()
    before = Q.nf4_gemv.launches
    got = Q.nf4_gemv(x, ql.data, scale, gs or 0, out_dtype).float()
    assert Q.nf4_gemv.launches == before + 1
    want = Q.nf4_gemv_plain(x, ql.data, scale, gs or 0, out_dtype).float()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=1e-2)


def test_nf4_routes_on_card(dev):
    """quantized_matmul of an NF4 weight on the card: the GEMV at M <= 64,
    no kernel (the bf16 product) at M >= 256; a shape off the gate raises
    in the wrapper, never falls back there."""
    from piquant_tpu_torch.quant.linear import quantized_matmul

    ql = _qlin(dev, 1024, 256, "nf4", 64, 5)
    before = Q.nf4_gemv.launches
    y8 = quantized_matmul(_x(dev, 8, 1024, 6), ql)
    y300 = quantized_matmul(_x(dev, 300, 1024, 7), ql)
    assert Q.nf4_gemv.launches == before + 1
    assert y8.shape == (8, 256) and y300.shape == (300, 256)
    x = _x(dev, 8, 1024, 8)
    with pytest.raises(ValueError):       # M > 64
        Q.nf4_gemv(_x(dev, 65, 1024, 9), ql.data, ql.scale, 64,
                   torch.bfloat16)
    with pytest.raises(ValueError):       # a group size off the planes
        Q.nf4_gemv(x, ql.data, ql.scale, 96, torch.bfloat16)
    with pytest.raises(TypeError):        # bf16 scales
        Q.nf4_gemv(x, ql.data, ql.scale.to(torch.bfloat16), 64,
                   torch.bfloat16)


def test_quantized_gemvs_refuse(dev):
    """Non-contiguous operands, wrong dtypes and shapes off the gates raise;
    nothing quietly falls back to a plain version on the card."""
    ql8 = _qlin(dev, 512, 256, 8, None, 1)
    ql2 = _qlin(dev, 512, 256, 2, None, 2)
    qg = _qlin(dev, 1024, 256, 4, 32, 3)
    x = _x(dev, 8, 1024, 4)
    x5 = x[:, :512]                                   # not contiguous
    xs = x5.float().sum(1, keepdim=True)
    s8, z8 = ql8.scale.reshape(-1).contiguous(), ql8.zero_point.reshape(-1).contiguous()
    with pytest.raises(ValueError):
        Q.w8_gemv(x5, ql8.data, s8, z8, xs, torch.bfloat16)
    with pytest.raises(TypeError):
        Q.w8_gemv(x5.contiguous().float(), ql8.data, s8, z8, xs, torch.bfloat16)
    with pytest.raises(ValueError):                   # M > 64
        Q.w2_gemv(_x(dev, 65, 512, 5), ql2.data, s8, z8,
                  torch.zeros(65, 1, device=dev), torch.bfloat16)
    with pytest.raises(ValueError):                   # codes not contiguous
        Q.w2_gemv(x5.contiguous(), ql2.data.t().contiguous().t(), s8, z8,
                  xs, torch.bfloat16)
    with pytest.raises(ValueError):                   # side stream transposed
        Q.wg_chunk(x, qg.data, qg.s_chunk.t().contiguous().t(), qg.z_chunk,
                   32, 8, torch.bfloat16)
    with pytest.raises(TypeError):
        Q.wg_chunk(x, qg.data, qg.s_chunk.float(), qg.z_chunk, 32, 8,
                   torch.bfloat16)
    with pytest.raises(ValueError):                   # group size off the planes
        Q.w4_grouped(x, qg.data, qg.scale, qg.zero_point, 48, torch.bfloat16)
    with pytest.raises(ValueError):
        Q.w4_grouped(x.t().contiguous().t(), qg.data, qg.scale,
                     qg.zero_point, 32, torch.bfloat16)


def _a8_inputs(dev, m, k, n, bits, seed):
    """Per-token int8 activations of a N(0, 1) x and a random channelwise
    weight's a8 operands, as the dispatch hands them over."""
    from piquant_tpu_torch.quant.linear import _quantize_act

    ql = _qlin(dev, k, n, bits, None, seed)
    xq, xs = _quantize_act(_x(dev, m, k, seed + 1))
    shift = 128 if bits == 8 else 0
    return (xq, xs, ql.data, *Q.a8_operands(xq, ql, shift))


A8 = {2: ("w2a8", 4), 4: ("w4a8", 2), 8: ("w8a8", 1)}


# Bit for bit: int32 accumulation is exact in both, and the epilogue runs
# unfused in the reference's order (__fmul_rn / __fsub_rn).  M covers the
# three tile heights (16, 64, 128 rows) and their ragged edges; the small
# weights at small M split K over blocks, the large ones at M 1000 do not.
@pytest.mark.parametrize("m", [1, 8, 16, 17, 33, 64, 65, 256, 1000])
@pytest.mark.parametrize("bits,k,n", [(4, 512, 256), (4, 4096, 1024),
                                      (4, 14336, 4096), (8, 512, 384),
                                      (8, 4096, 14336), (2, 512, 384),
                                      (2, 14336, 4096)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_a8_matches_plain(dev, m, bits, k, n, out_dtype):
    name, _ = A8[bits]
    kern, plain = getattr(Q, name), getattr(Q, name + "_plain")
    ops = _a8_inputs(dev, m, k, n, bits, m + k + n)
    before = kern.launches
    got = kern(*ops, out_dtype)
    assert kern.launches == before + 1
    torch.testing.assert_close(got, plain(*ops, out_dtype), atol=0, rtol=0)


def test_a8_refuses(dev):
    xq, xs, data, s, zs, xsum = _a8_inputs(dev, 8, 512, 256, 4, 3)
    with pytest.raises(TypeError):                    # bf16 x
        Q.w4a8(xq.to(torch.bfloat16), xs, data, s, zs, xsum, torch.bfloat16)
    with pytest.raises(ValueError):                   # codes not contiguous
        Q.w4a8(xq, xs, data.t().contiguous().t(), s, zs, xsum, torch.bfloat16)
    with pytest.raises(ValueError):                   # N % 128
        Q.w4a8(xq, xs, data[:, :200].contiguous(), s[:200].contiguous(),
               zs[:200].contiguous(), xsum, torch.bfloat16)
    with pytest.raises(ValueError):                   # xs of another M
        Q.w4a8(xq, xs[:4].contiguous(), data, s, zs, xsum, torch.bfloat16)


# The int8-x chunk form: atol 2e-2, rtol 1e-2 as the bf16-x form (exact
# products; the f32 sums run in another order).
@pytest.mark.parametrize("m", [1, 8, 33, 64])
@pytest.mark.parametrize("bits,k,n,gs", [(4, 512, 256, 32), (4, 4096, 1024, 128),
                                         (2, 1024, 256, 32), (2, 14336, 4096, 32)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_wg_chunk_int8_matches_plain(dev, m, bits, k, n, gs, out_dtype):
    from piquant_tpu_torch.quant.linear import (_quantize_act,
                                                grouped_chunk_factor)

    ql = _qlin(dev, k, n, bits, gs, k + gs + 2)
    ch = grouped_chunk_factor(k, gs, Q.PLANES[bits])
    xq, xs = _quantize_act(_x(dev, m, k, m + 3))
    before = Q.wg_chunk.launches
    got = Q.wg_chunk(xq, ql.data, ql.s_chunk, ql.z_chunk, gs, ch, out_dtype,
                     xs).float()
    assert Q.wg_chunk.launches == before + 1
    want = Q.wg_chunk_plain(xq, ql.data, ql.s_chunk, ql.z_chunk, gs, ch,
                            out_dtype, xs).float()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=1e-2)


def test_act_quant_routes_on_card(dev):
    """quantized_matmul(act_quant=...) launches the a8 kernels where the
    gates take the shape, and nothing falls back to a plain version."""
    from piquant_tpu_torch.quant.linear import quantized_matmul

    ql4 = _qlin(dev, 4096, 1024, 4, None, 5)
    ql8 = _qlin(dev, 14336, 256, 8, None, 6)
    before = (Q.w4a8.launches, Q.w8a8.launches, Q.w4_gemv.launches)
    quantized_matmul(_x(dev, 300, 4096, 7), ql4, act_quant=True)
    quantized_matmul(_x(dev, 8, 4096, 8), ql4, act_quant="all")
    quantized_matmul(_x(dev, 8, 4096, 9), ql4, act_quant=True)   # decode M
    quantized_matmul(_x(dev, 300, 14336, 10), ql8, act_quant=True)  # K > 8192
    assert (Q.w4a8.launches, Q.w8a8.launches, Q.w4_gemv.launches) == (
        before[0] + 2, before[1], before[2] + 1)


# Normalized context element by element within atol 2e-3, rtol 2e-2; m to
# f32 rounding; l within 2e-2 (bf16 probabilities at different running
# maxima in the two).
@pytest.mark.parametrize("rep", [1, 2, 3, 4, 5, 6, 7, 8])
def test_decode_attn2_matches_plain(dev, rep):
    g = _gen(dev, rep)
    nl, b, hkv, s, d = 3, 4, 2, 1024, 128
    shape = (nl, b, hkv, s, d)
    kc = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
    vc = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
    ks = torch.rand(shape[:-1] + (1,), generator=g, device=dev) * 0.02
    vs = torch.rand(shape[:-1] + (1,), generator=g, device=dev) * 0.02
    q = torch.randn((b, hkv, rep, d), generator=g, device=dev)
    pos = torch.tensor([0, 1, 700, 1024], dtype=torch.int32, device=dev)
    start = torch.tensor([0, 0, 300, 1000], dtype=torch.int32, device=dev)
    acc, m, l = DA.decode_attn2(q, kc, ks, vc, vs, pos, start, 0.0884, 2)
    pacc, pm, pl = DA.decode_attn2_plain(q, kc, ks, vc, vs, pos, start,
                                         0.0884, 2)
    assert (m[0] == -1e30).all() and (l[0] == 0).all() and (acc[0] == 0).all()
    torch.testing.assert_close(m, pm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, pl, rtol=2e-2, atol=0)
    torch.testing.assert_close(acc[1:] / l[1:], pacc[1:] / pl[1:],
                               atol=2e-3, rtol=2e-2)


def _kv4_cache(dev, g, nl, b, hkv, s, d):
    codes = [torch.randint(0, 256, (nl, b, hkv, s // 2, d), generator=g,
                           device=dev, dtype=torch.uint8) for _ in range(2)]
    scales = [torch.rand((nl, b, hkv, 2, s // 2), generator=g, device=dev)
              * 0.02 for _ in range(2)]
    return codes[0], scales[0], codes[1], scales[1]


# kv4 as kv8 above: odd positions and odd starts put the live window's ends
# on either half of a pair row; S not a multiple of the 256-position chunk.
@pytest.mark.parametrize("rep", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("s", [1024, 1000])
def test_decode_attn2_kv4_matches_plain(dev, rep, s):
    g = _gen(dev, rep + s)
    nl, b, hkv, d = 3, 5, 2, 128
    kc, ks, vc, vs = _kv4_cache(dev, g, nl, b, hkv, s, d)
    q = torch.randn((b, hkv, rep, d), generator=g, device=dev)
    pos = torch.tensor([0, 1, 701, s, 256], dtype=torch.int32, device=dev)
    start = torch.tensor([0, 0, 301, s - 3, 255], dtype=torch.int32,
                         device=dev)
    before = DA.decode_attn2_kv4.launches
    acc, m, l = DA.decode_attn2_kv4(q, kc, ks, vc, vs, pos, start, 0.0884, 2)
    assert DA.decode_attn2_kv4.launches == before + 1
    pacc, pm, pl = DA.decode_attn2_plain(q, kc, ks, vc, vs, pos, start,
                                         0.0884, 2)
    assert (m[0] == -1e30).all() and (l[0] == 0).all() and (acc[0] == 0).all()
    torch.testing.assert_close(m, pm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, pl, rtol=2e-2, atol=0)
    torch.testing.assert_close(acc[1:] / l[1:], pacc[1:] / pl[1:],
                               atol=2e-3, rtol=2e-2)


# Head dim 256 (Gemma), kv8 and kv4, at the reps of the Gemma presets (8:
# Gemma-2B, 1: Gemma-7B, 2: Gemma-2/3) and two more; bounds as above.  A kv4
# position is 128 bytes here: dim j in the low nibble, dim j + 128 in the
# high one.
@pytest.mark.parametrize("kv", ["kv8", "kv4"])
@pytest.mark.parametrize("rep", [1, 2, 3, 8])
def test_decode_attn2_d256_matches_plain(dev, kv, rep):
    g = _gen(dev, 256 + rep + (kv == "kv4"))
    nl, b, hkv, s, d = 3, 5, 2, 1000, 256
    if kv == "kv4":
        kc, ks, vc, vs = _kv4_cache(dev, g, nl, b, hkv, s, d)
        kern = DA.decode_attn2_kv4
    else:
        shape = (nl, b, hkv, s, d)
        kc, vc = (torch.randint(-127, 128, shape, generator=g, device=dev,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand(shape[:-1] + (1,), generator=g, device=dev)
                  * 0.02 for _ in range(2))
        kern = DA.decode_attn2
    q = torch.randn((b, hkv, rep, d), generator=g, device=dev)
    pos = torch.tensor([0, 1, 701, s, 256], dtype=torch.int32, device=dev)
    start = torch.tensor([0, 0, 301, s - 3, 255], dtype=torch.int32,
                         device=dev)
    before = kern.launches
    acc, m, l = kern(q, kc, ks, vc, vs, pos, start, 0.0625, 2)
    assert kern.launches == before + 1
    pacc, pm, pl = DA.decode_attn2_plain(q, kc, ks, vc, vs, pos, start,
                                         0.0625, 2)
    assert (m[0] == -1e30).all() and (l[0] == 0).all() and (acc[0] == 0).all()
    torch.testing.assert_close(m, pm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, pl, rtol=2e-2, atol=0)
    torch.testing.assert_close(acc[1:] / l[1:], pacc[1:] / pl[1:],
                               atol=2e-3, rtol=2e-2)


def test_decode_attn2_kv4_refuses(dev):
    g = _gen(dev, 7)
    kc, ks, vc, vs = _kv4_cache(dev, g, 1, 1, 1, 256, 128)
    q = torch.zeros((1, 1, 2, 128), device=dev)
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):            # kv8 codes to the kv4 kernel
        DA.decode_attn2_kv4(q, kc.view(torch.int8), ks, vc, vs, pos, pos,
                            1.0, 0)
    with pytest.raises(ValueError):           # scales not parity-split
        flat = ks.reshape(1, 1, 1, 256, 1)
        DA.decode_attn2_kv4(q, kc, flat, vc, flat, pos, pos, 1.0, 0)
    with pytest.raises(NotImplementedError):  # rep 9
        DA.decode_attn2_kv4(torch.zeros((1, 1, 9, 128), device=dev), kc, ks,
                            vc, vs, pos, pos, 1.0, 0)


def test_kv4_decode_step_on_card(dev):
    """One decode step of a small head_dim-128 model over a kv4 cache on
    the card (the kv4 kernel, once a layer) against the same step on the
    CPU (its plain version): logits within 2e-2 of the largest."""
    from piquant_tpu_torch.models import llama as M

    cfg = M.LlamaConfig(vocab_size=256, d_model=256, n_layers=2, n_heads=4,
                        n_kv_heads=2, d_ff=512, max_seq_len=256,
                        head_dim_override=128, kv_bits=4)
    params = M.random_quantized_params(cfg, 0, device="cpu")
    toks = torch.randint(1, 256, (2, 65), generator=torch.Generator()
                         .manual_seed(1), dtype=torch.int32)
    out = []
    for d in ("cpu", dev):
        p = _to(params, d)
        cache = M.init_kv_cache(cfg, 2, max_len=256, device=d)
        M.prefill(cfg, p, toks[:, :64].to(d), cache)
        before = DA.decode_attn2_kv4.launches
        lg, _ = M.decode_step(cfg, p, toks[:, 64].to(d),
                              torch.full((2,), 64, dtype=torch.int32,
                                         device=d), cache)
        if d == dev:
            assert DA.decode_attn2_kv4.launches == before + cfg.n_layers
        out.append(lg.float().cpu())
    err = (out[1] - out[0]).abs().max() / out[0].abs().max()
    assert err < 2e-2, err


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_window_model_on_card(dev, kv_bits, monkeypatch):
    """A small Mistral-like model (window 16, GQA rep 7, q/k/v biases and
    qk-norm) on the card: the windowed flash prefill at T = 128, then two
    decode steps whose window starts are past 0.  Logits within 2e-2 of
    the largest: the card's decode against the same steps on the card with
    the decode kernel swapped for its plain version, and (kv8) against the
    CPU (the plain versions throughout).

    The card's and the CPU's bf16 projections round apart, and a kv4 code
    moves by 1/7 of its row's absmax where they do, so kv4 does not hold
    the CPU bound (0.0282 on an H100); decoding the card from a copy of the
    CPU's prefilled cache narrows it only to 0.0222, so the gap lies in the
    step's own projections, not in the codes the prefill wrote.  The test
    prints the codes that differ between the two prefilled caches and the
    three readings."""
    from piquant_tpu_torch.models import llama as M
    from piquant_tpu_torch.quant.kv_cache import KVCache

    cfg = M.LlamaConfig(vocab_size=256, d_model=256, n_layers=2, n_heads=7,
                        n_kv_heads=1, d_ff=512, max_seq_len=256,
                        head_dim_override=128, sliding_window=16,
                        qkv_bias=True, qk_norm=True, kv_bits=kv_bits)
    params = M.random_quantized_params(cfg, 0, device="cpu")
    toks = torch.randint(1, 256, (2, 130), generator=torch.Generator()
                         .manual_seed(2), dtype=torch.int32)
    name = "decode_attn2_kv4" if kv_bits == 4 else "decode_attn2"
    kern = getattr(DA, name)
    p = {d: _to(params, d) for d in ("cpu", dev)}
    pre, caches = {}, {}
    for d in ("cpu", dev):
        caches[d] = M.init_kv_cache(cfg, 2, max_len=256, device=d)
        before = FL.flash_attn.launches
        pre[d] = M.prefill(cfg, p[d], toks[:, :128].to(d),
                           caches[d])[0].float().cpu()[None]
    assert FL.flash_attn.launches == before + cfg.n_layers

    def copy(cache, d):
        return KVCache(*(t.to(d, copy=True) for t in cache.tensors()))

    def decode(d, cache, launches):
        before = kern.launches
        lgs = [M.decode_step(cfg, p[d], toks[:, 128 + i].to(d),
                             torch.full((2,), 128 + i, dtype=torch.int32,
                                        device=d), cache)[0]
               for i in range(2)]
        assert kern.launches == before + launches
        return torch.cat([pre[d], torch.stack(lgs).float().cpu()])

    codes = [(caches["cpu"].k_codes, caches[dev].k_codes.cpu()),
             (caches["cpu"].v_codes, caches[dev].v_codes.cpu())]
    if kv_bits == 4:                    # two codes a byte
        codes = [(c & 15, g & 15) for c, g in codes] + [
            (c >> 4, g >> 4) for c, g in codes]
    flips = sum(int((c != g).sum()) for c, g in codes)
    total = 2 * cfg.n_layers * 2 * cfg.n_kv_heads * 128 * cfg.head_dim
    want = decode("cpu", copy(caches["cpu"], "cpu"), 0)
    scale = want.abs().max()
    got = decode(dev, copy(caches[dev], dev), 2 * cfg.n_layers)
    shared = decode(dev, copy(caches["cpu"], dev), 2 * cfg.n_layers)
    monkeypatch.setattr(DA, name, DA.decode_attn2_plain)
    plain = decode(dev, caches[dev], 0)
    err_kernel = float((got - plain).abs().max() / scale)
    err_cpu = float((got - want).abs().max() / scale)
    err_shared = float((shared - want).abs().max() / scale)
    print(f"kv{kv_bits} window 16: {flips} of {total} prefilled codes differ "
          f"between card and CPU; logits error {err_kernel:.3e} against the "
          f"card's plain decode, {err_cpu:.3e} against the CPU, "
          f"{err_shared:.3e} against the CPU from the CPU's cache")
    assert err_kernel < 2e-2, err_kernel
    if kv_bits == 8:
        assert err_cpu < 2e-2, err_cpu


@pytest.mark.parametrize("family", ["gemma2", "gemma3"])
@pytest.mark.parametrize("kv_bits", [8, 4])
def test_gemma_model_on_card(dev, family, kv_bits, monkeypatch):
    """A small head_dim-256 Gemma-2 (softcaps, sandwich norms) or Gemma-3
    (qk-norm, a rope base for local and for global layers) with a window of
    16 on every other layer, on the card: flash prefill at T = 128 with the
    softcap (Gemma-2) or without, then two decode steps, which under the
    softcap take the materialized path (no decode kernel) and else
    decode_attn2 with window starts past 0 on the local layer.  Logits
    within 2e-2 of the largest (test_window_model_on_card's bounds): the
    card against the card with both kernels swapped for their plain
    versions, and (kv8) against the CPU; the kv4 CPU reading is printed.
    Norm weights are offsets from the seed in [-0.5, 0.5), as a Gemma
    checkpoint stores them (the init's ones would scale every norm by
    1 + w = 2)."""
    from piquant_tpu_torch.models import llama as M

    flags = (dict(sandwich_norms=True, attn_softcap=50.0,
                  final_softcap=30.0) if family == "gemma2" else
             dict(sandwich_norms=True, qk_norm=True, rope_theta=1e6,
                  rope_theta_local=1e4, rope_linear_factor=8.0))
    cfg = M.LlamaConfig(vocab_size=256, d_model=256, n_layers=2, n_heads=4,
                        n_kv_heads=2, d_ff=512, max_seq_len=256,
                        head_dim_override=256, norm_plus_one=True,
                        mlp_act="gelu", scale_embed=True,
                        attn_scale_override=256.0 ** -0.5, sliding_window=16,
                        sliding_pattern=2, kv_bits=kv_bits, **flags)
    params = M.random_quantized_params(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    for layer in params["layers"] + [params]:
        for k, w in list(layer.items()):
            if k.endswith("norm"):
                layer[k] = (torch.rand(w.shape, generator=gen) - 0.5).to(w.dtype)
    toks = torch.randint(1, 256, (2, 130), generator=torch.Generator()
                         .manual_seed(4), dtype=torch.int32)
    name = "decode_attn2_kv4" if kv_bits == 4 else "decode_attn2"
    per_step = 0 if cfg.attn_softcap else cfg.n_layers
    p = {d: _to(params, d) for d in ("cpu", dev)}
    kernels = (FL.flash_attn, getattr(DA, name))

    def run(d, launches):
        cache = M.init_kv_cache(cfg, 2, max_len=256, device=d)
        before = [k.launches for k in kernels]
        out = [M.prefill(cfg, p[d], toks[:, :128].to(d), cache)[0]]
        out += [M.decode_step(cfg, p[d], toks[:, 128 + i].to(d),
                              torch.full((2,), 128 + i, dtype=torch.int32,
                                         device=d), cache)[0]
                for i in range(2)]
        assert tuple(k.launches - n
                     for k, n in zip(kernels, before)) == launches
        return torch.stack(out).float().cpu()

    want = run("cpu", (0, 0))
    got = run(dev, (cfg.n_layers, 2 * per_step))
    monkeypatch.setattr(FL, "flash_attn", FL.flash_attn_plain)
    monkeypatch.setattr(DA, name, DA.decode_attn2_plain)
    plain = run(dev, (0, 0))
    scale = want.abs().max()
    err_kernel = float((got - plain).abs().max() / scale)
    err_cpu = float((got - want).abs().max() / scale)
    print(f"{family} kv{kv_bits}: logits error {err_kernel:.3e} against "
          f"the card's plain versions, {err_cpu:.3e} against the CPU")
    assert err_kernel < 2e-2, err_kernel
    if kv_bits == 8:
        assert err_cpu < 2e-2, err_cpu


def _to(tree, d):
    """A params tree with every tensor moved to device d."""
    import dataclasses

    if isinstance(tree, dict):
        return {k: _to(v, d) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, d) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(d)
    return dataclasses.replace(tree, **{
        f.name: getattr(tree, f.name).to(d) for f in dataclasses.fields(tree)
        if isinstance(getattr(tree, f.name), torch.Tensor)})


def test_decode_attn2_refuses(dev):
    q = torch.zeros((1, 1, 9, 128), device=dev)
    kc = torch.zeros((1, 1, 1, 256, 128), dtype=torch.int8, device=dev)
    ks = torch.zeros((1, 1, 1, 256, 1), device=dev)
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError):          # rep 9
        DA.decode_attn2(q, kc, ks, kc, ks, pos, pos, 1.0, 0)
    with pytest.raises(NotImplementedError):          # head_dim 384
        DA.decode_attn2(torch.zeros((1, 1, 2, 384), device=dev),
                        torch.zeros((1, 1, 1, 256, 384), dtype=torch.int8,
                                    device=dev), ks, kc, ks, pos, pos, 1.0, 0)


# Output element by element within atol 2e-3, rtol 2e-2 (bf16
# probabilities before PV in both; another tile order for the online
# softmax).
@pytest.mark.parametrize("rep,t", [(1, 256), (2, 384), (4, 200), (8, 128),
                                   (3, 256), (5, 128), (6, 384), (7, 200)])
def test_flash_matches_plain(dev, rep, t):
    g = _gen(dev, rep * t)
    b, hkv, d = 2, 2, 128
    q = torch.randn((b, hkv, rep, t, d), generator=g, device=dev)
    k = torch.randn((b, hkv, t, d), generator=g, device=dev)
    v = torch.randn((b, hkv, t, d), generator=g, device=dev)
    got = FL.flash_attn(q, k, v, d ** -0.5)
    want = FL.flash_attn_plain(q, k, v, d ** -0.5)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-2)


# The sliding window as flash_attn_plain takes it, at every rep: windows of
# 1 (the diagonal alone), 63 and 100 (not multiples of the 64-key tile),
# 200 and one wider than T (the causal mask); T of whole 128-row tiles and
# ragged.  Bounds as above.
@pytest.mark.parametrize("rep", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("window,t", [(1, 256), (63, 384), (100, 200),
                                      (200, 512), (1000, 256)])
def test_flash_window_matches_plain(dev, rep, window, t):
    g = _gen(dev, rep * t + window)
    b, hkv, d = 2, 2, 128
    q = torch.randn((b, hkv, rep, t, d), generator=g, device=dev)
    k = torch.randn((b, hkv, t, d), generator=g, device=dev)
    v = torch.randn((b, hkv, t, d), generator=g, device=dev)
    before = FL.flash_attn.launches
    got = FL.flash_attn(q, k, v, d ** -0.5, window)
    assert FL.flash_attn.launches == before + 1
    want = FL.flash_attn_plain(q, k, v, d ** -0.5, window)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-2)
    if window == 1:     # the diagonal alone: out = v
        torch.testing.assert_close(
            got, v.to(torch.bfloat16).float()[:, :, None].expand_as(got),
            atol=0, rtol=0)


def _context_f32_probs(q, k, v, sm, window, softcap):
    """The flash function with the probabilities left unrounded."""
    t = q.shape[-2]
    s = torch.einsum("bhrtd,bhsd->bhrts", q.bfloat16().float(),
                     k.bfloat16().float()) * sm
    if softcap is not None:
        s = softcap * torch.tanh(s * (1.0 / softcap))
    idx = torch.arange(t, device=q.device)
    dead = idx[None] > idx[:, None]
    if window is not None:
        dead |= idx[None] <= idx[:, None] - window
    p = torch.softmax(s.masked_fill(dead, float("-inf")), dim=-1)
    return torch.einsum("bhrts,bhsd->bhrtd", p, v.bfloat16().float())


# Head dim 256 (Gemma) and the softcap: causal and windowed, T of whole
# tiles and ragged, at the Gemma reps and two more.  Unit-normal scores
# (scale d^-0.5; a cap of 2 bites there) within the bounds above.  Peaked
# scores (q and k doubled at Gemma-2's scale 1/16: a spread of 2.8 at D 128,
# 4 at D 256) let a few keys dominate a row, and one bf16 rounding of a
# dominant probability moves the context past atol 2e-3: there the kernel
# stays within one rounding (`rounding_bound`, and 1e-4 for the f32 sums)
# of the context with unrounded probabilities, and within the stated bound
# plus two roundings of the plain version, which rounds against the row's
# max where the kernel rounds against the running one.
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("rep", [1, 2, 5, 8])
@pytest.mark.parametrize("window,softcap,t", [(None, None, 256),
                                              (None, 50.0, 384),
                                              (None, 2.0, 200),
                                              (100, None, 256),
                                              (63, 2.0, 384)])
@pytest.mark.parametrize("peaked", [False, True])
def test_flash_gemma_matches_plain(dev, d, rep, window, softcap, t, peaked):
    g = _gen(dev, d + rep * t)
    b, hkv = 2, 2
    widen, sm = (2.0, 1 / 16) if peaked else (1.0, d ** -0.5)
    q = torch.randn((b, hkv, rep, t, d), generator=g, device=dev) * widen
    k = torch.randn((b, hkv, t, d), generator=g, device=dev) * widen
    v = torch.randn((b, hkv, t, d), generator=g, device=dev)
    before = FL.flash_attn.launches
    got = FL.flash_attn(q, k, v, sm, window, softcap)
    assert FL.flash_attn.launches == before + 1
    want = FL.flash_attn_plain(q, k, v, sm, window, softcap)
    if not peaked:
        torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-2)
        return
    r = FL.rounding_bound(q, k, v, sm, window, softcap)
    exact = _context_f32_probs(q, k, v, sm, window, softcap)
    assert bool(((got - exact).abs() <= 1e-4 + r).all())
    assert bool(((got - want).abs()
                 <= 2e-3 + 2e-2 * want.abs() + 2 * r).all())


# Llama-4's chunk (96: off the 64-key tiles; pos0 0, and 40 and 1000 so a
# boundary falls inside a 16-row warp) and GPT-OSS's sinks (N(0, 1), the
# first query head's lifted by 3 so the sink dominates some rows), in
# every combination with each other, the window (63) and the softcap (2),
# at D 128 and 256, T of whole tiles and ragged, reps 1, 5 and 8.  Chunk
# starts leave a row few live keys, where one bf16 rounding of a dominant
# probability moves the context past atol 2e-3 (as under peaked scores
# above): the kernel stays within the stated bound plus two roundings of
# the plain version (`rounding_bound`).  Every sink moves the context
# beyond that bound.
FLASH_MODES = {
    "chunk": dict(chunk=96), "chunk_pos0": dict(chunk=96, pos0=(40, 1000)),
    "sinks": dict(sinks=True), "sinks_window": dict(sinks=True, window=63),
    "sinks_chunk": dict(sinks=True, chunk=96, pos0=(40, 1000)),
    "sinks_softcap": dict(sinks=True, softcap=2.0),
    "chunk_softcap": dict(chunk=96, pos0=(40, 1000), softcap=2.0),
    "all_but_window": dict(sinks=True, chunk=96, pos0=(7, 0), softcap=2.0),
    "sinks_window_softcap": dict(sinks=True, window=63, softcap=2.0)}


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("rep", [1, 5, 8])
@pytest.mark.parametrize("mode", list(FLASH_MODES))
@pytest.mark.parametrize("t", [256, 200])
def test_flash_chunk_sinks_match_plain(dev, d, rep, mode, t):
    g = _gen(dev, d + rep * t + len(mode))
    b, hkv = 2, 2
    kw = dict(FLASH_MODES[mode])
    if kw.pop("sinks", False):
        kw["sinks"] = torch.randn((hkv, rep), generator=g, device=dev)
        kw["sinks"][:, 0] += 3.0
    if "pos0" in kw:
        kw["pos0"] = torch.tensor(kw["pos0"], dtype=torch.int32, device=dev)
    q = torch.randn((b, hkv, rep, t, d), generator=g, device=dev)
    k = torch.randn((b, hkv, t, d), generator=g, device=dev)
    v = torch.randn((b, hkv, t, d), generator=g, device=dev)
    sm = d ** -0.5
    before = FL.flash_attn.launches
    got = FL.flash_attn(q, k, v, sm, **kw)
    assert FL.flash_attn.launches == before + 1
    want = FL.flash_attn_plain(q, k, v, sm, **kw)
    lim = 2e-3 + 2e-2 * want.abs() + 2 * FL.rounding_bound(q, k, v, sm, **kw)
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= lim).all())
    if "sinks" in kw:
        bare = FL.flash_attn_plain(q, k, v, sm, **{
            n: a for n, a in kw.items() if n != "sinks"})
        assert bool(((bare - want).abs() > lim).any())


# A long prefill across many chunk boundaries at Llama-4's rep 5: T 2048,
# chunk 300, pos0 0 and 4000; bounds as above.
@pytest.mark.parametrize("p0", [(0,), (4000,)])
def test_flash_chunk_long_matches_plain(dev, p0):
    g = _gen(dev, 2048 + p0[0])
    q = torch.randn((1, 2, 5, 2048, 128), generator=g, device=dev)
    k = torch.randn((1, 2, 2048, 128), generator=g, device=dev)
    v = torch.randn((1, 2, 2048, 128), generator=g, device=dev)
    pos0 = torch.tensor(p0, dtype=torch.int32, device=dev)
    got = FL.flash_attn(q, k, v, 128 ** -0.5, chunk=300, pos0=pos0)
    want = FL.flash_attn_plain(q, k, v, 128 ** -0.5, chunk=300, pos0=pos0)
    lim = 2e-3 + 2e-2 * want.abs() + 2 * FL.rounding_bound(
        q, k, v, 128 ** -0.5, chunk=300, pos0=pos0)
    assert bool(((got - want).abs() <= lim).all())


def test_flash_chunk_sinks_refuse(dev):
    q = torch.zeros((1, 1, 2, 128, 128), device=dev)
    k = torch.zeros((1, 1, 128, 128), device=dev)
    with pytest.raises(ValueError):                   # a chunk and a window
        FL.flash_attn(q, k, k, 1.0, 64, chunk=64)
    with pytest.raises(ValueError):                   # chunk 0
        FL.flash_attn(q, k, k, 1.0, chunk=0)
    with pytest.raises(ValueError):                   # 3 sinks for 2 heads
        FL.flash_attn(q, k, k, 1.0, sinks=torch.zeros(3, device=dev))
    with pytest.raises(ValueError):                   # pos0 of 2 rows
        FL.flash_attn(q, k, k, 1.0, chunk=64,
                      pos0=torch.zeros(2, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):                   # sinks on the CPU
        FL.flash_attn(q, k, k, 1.0, sinks=torch.zeros(2))


def test_flash_refuses(dev):
    q = torch.zeros((1, 1, 2, 128, 64), device=dev)
    k = torch.zeros((1, 1, 128, 64), device=dev)
    with pytest.raises(NotImplementedError):          # head_dim 64
        FL.flash_attn(q, k, k, 1.0)
    with pytest.raises(NotImplementedError):          # head_dim 384
        FL.flash_attn(torch.zeros((1, 1, 2, 128, 384), device=dev),
                      torch.zeros((1, 1, 128, 384), device=dev),
                      torch.zeros((1, 1, 128, 384), device=dev), 1.0)
    with pytest.raises(ValueError):                   # softcap 0
        FL.flash_attn(torch.zeros((1, 1, 2, 128, 128), device=dev),
                      torch.zeros((1, 1, 128, 128), device=dev),
                      torch.zeros((1, 1, 128, 128), device=dev), 1.0,
                      softcap=0.0)
    with pytest.raises(NotImplementedError):          # rep 9
        FL.flash_attn(torch.zeros((1, 1, 9, 128, 128), device=dev),
                      torch.zeros((1, 1, 128, 128), device=dev),
                      torch.zeros((1, 1, 128, 128), device=dev), 1.0)
    with pytest.raises(ValueError):                   # window 0
        FL.flash_attn(torch.zeros((1, 1, 2, 128, 128), device=dev),
                      torch.zeros((1, 1, 128, 128), device=dev),
                      torch.zeros((1, 1, 128, 128), device=dev), 1.0, 0)


# ---------------------------------------------------------------------------
# the library core: every kernel bit for bit against its plain version
# ---------------------------------------------------------------------------

CODES = ["uint8", "int8", "uint16", "int16", "uint4", "int4", "uint2"]
EDGE = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.49999997, -0.49999997,
        float("nan"), float("inf"), float("-inf"), 3e9, -3e9, 1e-45, -0.0,
        7.5, -7.5, 128.5, -128.5]


def _bits(t):
    """Integer codes as a tensor torch.equal takes on the card (uint16 has
    no comparison kernels there; int16 has the same bits)."""
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def _same(got, want, equal_nan=False):
    if got.dtype.is_floating_point:
        torch.testing.assert_close(got, want, atol=0, rtol=0,
                                   equal_nan=equal_nan)
    else:
        assert got.dtype == want.dtype and torch.equal(_bits(got), _bits(want))


def _lib_x(dev, n, dtype, seed, offset=0):
    g = _gen(dev, seed)
    x = torch.rand(n + offset, generator=g, device=dev) * 8 - 3
    x[offset:offset + len(EDGE)][:n] = torch.tensor(EDGE[:n], device=dev)
    return x.to(dtype)[offset:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qname", CODES)
@pytest.mark.parametrize("n,offset", [(100_003, 0), (100_003, 1), (1, 0),
                                      (3, 0), (5, 0), (8, 3)])
def test_quantize_matches_plain(dev, dtype, qname, n, offset):
    x = _lib_x(dev, n, dtype, n + offset, offset)
    dt = DTYPES[qname]
    scale = torch.tensor(0.043, device=dev)
    zp = torch.tensor(dt.qmax // 3, dtype=torch.int32, device=dev)
    for stochastic in (False, True):
        before = QK.quantize.launches
        got = QK.quantize(x, scale, zp, dt, stochastic, seed=99 + n)
        assert QK.quantize.launches == before + 1
        _same(got, QK.quantize_plain(x, scale, zp, dt, stochastic, 99 + n))
        # host scalars: the same codes as the device-resident ones
        _same(QK.quantize(x, 0.043, dt.qmax // 3, dt, stochastic, 99 + n),
              got)


@pytest.mark.parametrize("odtype", ["f32", "bf16"])
@pytest.mark.parametrize("qname", CODES)
@pytest.mark.parametrize("n,offset", [(100_003, 0), (100_003, 1), (1, 0),
                                      (3, 0), (5, 0)])
def test_dequantize_matches_plain(dev, odtype, qname, n, offset):
    dt, odt = DTYPES[qname], DTYPES[odtype]
    g = _gen(dev, n)
    raw = torch.randint(0, 256, (dt.stride * (n if not dt.is_packed else
                                               -(-n // dt.pack_factor))
                                 + 16,), generator=g, device=dev,
                        dtype=torch.uint8)
    start = offset * dt.stride
    q = raw[start:start + raw.numel() - 16].view(dt.storage)
    _same(DQ.dequantize(q, n, 0.07, 11, dt, odt),
          DQ.dequantize_plain(q, n, 0.07, 11, dt, odt))
    # ADD in place into a (misaligned when offset) view of a larger buffer
    buf = torch.randn(n + 7, generator=g, device=dev).to(odt.storage)
    ref_buf = buf.clone()
    view = buf[offset:offset + n]
    res = DQ.dequantize(q, n, 0.07, 11, dt, odt, add_into=view)
    assert res.data_ptr() == view.data_ptr()
    DQ.dequantize_plain(q, n, 0.07, 11, dt, odt,
                        add_into=ref_buf[offset:offset + n])
    _same(buf, ref_buf)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qname", CODES)
@pytest.mark.parametrize("n,offset", [(100_003, 0), (100_003, 1), (5, 0)])
def test_requantize_matches_plain(dev, dtype, qname, n, offset):
    dt = DTYPES[qname]
    x = _lib_x(dev, n, dtype, n, offset)
    scale, zp = 8.0 / (dt.qmax - dt.qmin), (dt.qmax + dt.qmin) // 2
    for stochastic in (False, True):
        _same(RQ.requantize(x, scale, zp, dt, stochastic, 5),
              RQ.requantize_plain(x, scale, zp, dt, stochastic, 5))
        acc = torch.randn(n, generator=_gen(dev, 1), device=dev).to(dtype)
        acc2 = acc.clone()
        RQ.requantize(x, scale, zp, dt, stochastic, 5, add_into=acc)
        RQ.requantize_plain(x, scale, zp, dt, stochastic, 5, add_into=acc2)
        _same(acc, acc2)
    # in place on x itself (x + fq(x): the edge vector's NaN stays NaN)
    y = x.clone()
    RQ.requantize(y, scale, zp, dt, add_into=y)
    _same(y, x + RQ.requantize_plain(x, scale, zp, dt), equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,offset", [(1, 0), (1000, 1), (3_000_017, 0)])
def test_min_max_matches_plain(dev, dtype, n, offset):
    x = (torch.randn(n + offset, generator=_gen(dev, n), device=dev) * 3
         ).to(dtype)[offset:]
    _same(MM.min_max(x), MM.min_max_plain(x))
    x[n // 2] = float("nan")
    got = MM.min_max(x)
    assert got.isnan().all()
    torch.testing.assert_close(got, MM.min_max_plain(x), equal_nan=True)


def test_device_reciprocal_is_numpy_reciprocal(dev):
    """torch.reciprocal on the card (the plain version's 1/scale for a
    device scale) is the IEEE quotient numpy gives, over 10^5 scales; and
    the kernel's __frcp_rn agrees at half-code ties over 2,000 of them."""
    import numpy as np

    rng = np.random.default_rng(7)
    s = (10.0 ** rng.uniform(-8, 8, 100_000)).astype(np.float32)
    got = torch.reciprocal(torch.from_numpy(s).to(dev)).cpu().numpy()
    np.testing.assert_array_equal(got, np.float32(1.0) / s)
    k = torch.arange(-64, 64, device=dev, dtype=torch.float64) + 0.5
    for sc in s[:2000]:
        x = (k * float(sc)).float()
        # kernel: __frcp_rn of the device scale; plain: numpy's 1/scale
        _same(QK.quantize(x, torch.tensor(sc, device=dev), 0, DTYPES["int16"]),
              QK.quantize_plain(x, float(sc), 0, DTYPES["int16"]))


def test_library_wrappers_refuse(dev):
    x = torch.zeros(64, device=dev)
    u8 = DTYPES["uint8"]
    with pytest.raises(TypeError):                      # f64 input
        QK.quantize(x.double(), 0.1, 0, u8)
    with pytest.raises(TypeError):                      # 32-bit codes
        QK.quantize(x, 0.1, 0, DTYPES["int32"])
    with pytest.raises(ValueError):                     # not contiguous
        QK.quantize(x[::2], 0.1, 0, u8)
    with pytest.raises(ValueError):                     # 2-D
        RQ.requantize(x.reshape(8, 8), 0.1, 0, u8)
    with pytest.raises(ValueError):                     # scale elsewhere
        QK.quantize(x, torch.ones(2, device=dev), 0, u8)
    q = torch.zeros(64, dtype=torch.uint8, device=dev)
    with pytest.raises(TypeError):                      # codes not storage
        DQ.dequantize(q.int(), 64, 0.1, 0, u8, DTYPES["f32"])
    with pytest.raises(ValueError):                     # wrong size
        DQ.dequantize(q, 65, 0.1, 0, u8, DTYPES["f32"])
    with pytest.raises(ValueError):                     # accumulator dtype
        DQ.dequantize(q, 64, 0.1, 0, u8, DTYPES["f32"],
                      add_into=torch.zeros(64, dtype=torch.bfloat16,
                                           device=dev))
    with pytest.raises(ValueError):                     # accumulator device
        RQ.requantize(x, 0.1, 0, u8, add_into=torch.zeros(64))
    with pytest.raises(TypeError):
        MM.min_max(torch.zeros(8, dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# ragged MoE expert GEMMs (csrc/qmatmul_ragged.cu, csrc/qmatmul_a8.cu)
# ---------------------------------------------------------------------------

def _routed_x(dev, e, k, ntok, skew, seed):
    """x [m_pad, k] bf16 sorted and padded by a routing of ntok tokens, and
    its block_expert.  skew "random": top 2 of random logits; "zero":
    expert 0 gets no token and expert 1 nearly all; "all": every token
    goes to expert 1 alone (top 1), the tail blocks to the last expert."""
    from piquant_tpu_torch.quant import moe as MO

    g = _gen(dev, seed)
    logits = torch.randn((ntok, e), generator=g, device=dev)
    if skew == "zero":
        logits[:, 0] -= 50
        logits[:, 1] += 3
    top = 1 if skew == "all" else 2
    topi = (torch.ones((ntok, 1), dtype=torch.long, device=dev)
            if skew == "all" else logits.topk(top, dim=-1).indices)
    probs = torch.rand((ntok, top), generator=g, device=dev)
    r = MO.build_ragged_routing(topi[None], probs[None], e, 128)
    x = _x(dev, ntok, k, seed + 1)
    return MO.scatter_tokens(x, r), r


def _stack(dev, e, k, n, bits, gs, seed):
    from piquant_tpu_torch.quant.linear import QuantizedExpertStack

    return QuantizedExpertStack.stack(
        [_qlin(dev, k, n, bits, gs, seed + i) for i in range(e)])


def _pad_rows(r, m):
    """Rows of the sorted buffer that no assignment fills."""
    used = torch.zeros(m, dtype=torch.bool, device=r.dest.device)
    used[r.dest] = True
    return ~used


# bf16 x: atol 2e-2, rtol 1e-2, as the GEMVs (bf16 operands in both, f32
# sums in another order, one bf16 output rounding).  The padding rows are
# computed too and come out exactly zero.
@pytest.mark.parametrize("skew", ["random", "zero", "all"])
@pytest.mark.parametrize("bits,gs,e,k,n", [
    (4, None, 4, 512, 256), (2, None, 8, 1024, 384), (8, None, 4, 512, 128),
    (4, 128, 8, 4096, 256), (2, 32, 4, 1024, 256), (4, 16, 4, 512, 256),
    (8, 64, 4, 512, 128)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_ragged_matches_plain(dev, skew, bits, gs, e, k, n, out_dtype):
    from piquant_tpu_torch.ops.cuda import ragged as R

    st = _stack(dev, e, k, n, bits, gs, k + n + bits)
    x, r = _routed_x(dev, e, k, 300, skew, e + k)
    kern = R.wq_ragged_grouped if gs else R.wq_ragged
    before = kern.launches
    got = R.wq_ragged_matmul(x, st, r.block_expert, out_dtype)
    assert kern.launches == before + 1 and got.dtype == out_dtype
    if gs:
        want = R.wq_ragged_grouped_plain(x, st.data, st.scale, st.zero_point,
                                         gs, r.block_expert, out_dtype)
    else:
        s, zs = R._channel_side(st)
        want = R.wq_ragged_plain(x, st.data, s, zs,
                                 x.float().sum(1, keepdim=True),
                                 r.block_expert, out_dtype)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=1e-2)
    assert not got[_pad_rows(r, x.shape[0])].any()


# int8 x: bit for bit, as the dense a8 kernels (exact int32 products, the
# epilogue unfused in the reference's order).
@pytest.mark.parametrize("skew", ["random", "zero", "all"])
@pytest.mark.parametrize("bits,e,k,n", [(4, 4, 512, 256), (4, 8, 4096, 384),
                                        (2, 4, 1024, 256), (2, 8, 2048, 128)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_ragged_a8_matches_plain(dev, skew, bits, e, k, n, out_dtype):
    from piquant_tpu_torch.ops.cuda import ragged as R
    from piquant_tpu_torch.quant.linear import _quantize_act

    st = _stack(dev, e, k, n, bits, None, k + n)
    x, r = _routed_x(dev, e, k, 300, skew, e + k + 1)
    xq, xs = _quantize_act(x)
    before = R.wq_ragged_a8.launches
    got = R.wq_ragged_matmul_a8(xq, xs, st, r.block_expert, out_dtype)
    assert R.wq_ragged_a8.launches == before + 1
    s, zs = R._channel_side(st)
    want = R.wq_ragged_a8_plain(xq, xs, st.data, s, zs,
                                xq.float().sum(1, keepdim=True),
                                r.block_expert, out_dtype)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert not got[_pad_rows(r, x.shape[0])].any()


def test_ragged_refuses(dev):
    from piquant_tpu_torch.ops.cuda import ragged as R

    st = _stack(dev, 2, 512, 256, 4, None, 1)
    s, zs = R._channel_side(st)
    x = _x(dev, 256, 512, 2)
    xsum = x.float().sum(1, keepdim=True)
    be = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):                    # f32 x
        R.wq_ragged(x.float(), st.data, s, zs, xsum, be, torch.bfloat16)
    with pytest.raises(TypeError):                    # int64 block_expert
        R.wq_ragged(x, st.data, s, zs, xsum, be.long(), torch.bfloat16)
    with pytest.raises(ValueError):                   # not 128 rows a block
        R.wq_ragged(x[:200], st.data, s, zs, xsum[:200], be, torch.bfloat16)
    with pytest.raises(ValueError):                   # N % 128
        R.wq_ragged(x, st.data[..., :200].contiguous(), s[:, :200], zs[:, :200],
                    xsum, be, torch.bfloat16)
    with pytest.raises(ValueError):                   # codes not contiguous
        R.wq_ragged(x, st.data.transpose(1, 2).contiguous().transpose(1, 2),
                    s, zs, xsum, be, torch.bfloat16)
    with pytest.raises(ValueError):                   # group size off the planes
        R.wq_ragged_grouped(x, st.data, st.scale.expand(2, 2, 256).contiguous(),
                            st.zero_point.expand(2, 2, 256).contiguous(), 384,
                            be, torch.bfloat16)
    xq = torch.zeros((256, 512), dtype=torch.int8, device=dev)
    st8 = _stack(dev, 2, 512, 256, 8, None, 3)
    s8, zs8 = R._channel_side(st8)
    with pytest.raises(ValueError):                   # INT8 codes with int8 x
        R.wq_ragged_a8(xq, xsum, st8.data, s8, zs8, xsum, be, torch.bfloat16)


def test_moe_routes_on_card(dev):
    """The MoE MLP on CUDA tensors launches the ragged kernel at prefill
    and the GEMVs at decode; nothing falls back to a plain version."""
    from piquant_tpu_torch.models import llama as M
    from piquant_tpu_torch.ops.cuda import ragged as R

    cfg = M.LlamaConfig.tiny(n_experts=4, moe_top_k=2)
    params = M.random_quantized_params(cfg, 5, device=dev)
    layer = params["layers"][0]
    before = (R.wq_ragged.launches, Q.w4_gemv.launches)
    for t in (64, 8):
        y = M._mlp(cfg, layer, _x(dev, t, cfg.d_model, t).reshape(1, t, -1))
        assert bool(torch.isfinite(y).all())
    assert (R.wq_ragged.launches, Q.w4_gemv.launches) == (
        before[0] + 3, before[1] + 12)
