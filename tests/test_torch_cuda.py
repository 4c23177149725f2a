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
from piquant_tpu_torch.ops.cuda import _build
from piquant_tpu_torch.ops.cuda import decode_attn2 as DA
from piquant_tpu_torch.ops.cuda import dequantize as DQ
from piquant_tpu_torch.ops.cuda import minmax as MM
from piquant_tpu_torch.ops.cuda import quantize as QK
from piquant_tpu_torch.ops.cuda import requantize as RQ
from piquant_tpu_torch.ops.cuda import flash as FL
from piquant_tpu_torch.ops.cuda import qmatmul as Q
from piquant_tpu_torch.ops.cuda import ring as RG
from piquant_tpu_torch.quant.linear import QuantizedLinear

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


# Every M the GEMV template takes in one block: its n8-tile steps (1, 2, 4,
# 8 tiles), their edges and ragged M.
GEMV_M = [1, 8, 9, 16, 33, 63, 64]


# bf16 outputs: atol 2e-2 + rtol 1e-2 (the quantized_matmul bound of the
# JAX tests, which also covers one bf16 rounding of an O(1) output).  The
# shapes: a single stage, N an odd multiple of 128 (1152, 384), K split
# over a cluster (N 1024 and 4096) and unsplit (K 256; N 14336 at M > 8).
# xsum given (the caller's) or None (summed in the kernel).
@pytest.mark.parametrize("m", GEMV_M)
@pytest.mark.parametrize("k,n", [(256, 512), (4096, 1024), (512, 384),
                                 (8704, 1024), (4096, 1152), (14336, 4096),
                                 (4096, 14336)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("given", [True, False])
def test_w4_gemv_matches_plain(dev, m, k, n, out_dtype, given):
    g = _gen(dev, m + k)
    data = torch.randint(0, 256, (k // 2, n), generator=g, device=dev,
                         dtype=torch.uint8)
    scale = torch.rand(n, generator=g, device=dev) * 0.02 + 0.01
    zp = torch.randint(0, 16, (n,), generator=g, device=dev, dtype=torch.int32)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    xsum = x.float().sum(1, keepdim=True) if given else None
    before = Q.w4_gemv.launches
    got = Q.w4_gemv(x, data, scale, zp, xsum, out_dtype).float()
    assert Q.w4_gemv.launches == before + 1
    want = Q.w4_gemv_plain(x, data, scale, zp, xsum, out_dtype).float()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=1e-2)


def test_gemv_split_on_card(dev):
    """The chooser with this card's stage rows and cluster residency: a K
    split over a cluster at the Llama-3-8B projections at M = 8 (all but
    the INT8 lm_head, whose 1002 column tiles fill the card alone), none at
    K 256; every split whole stages, covering the packed rows once."""
    index = torch.cuda.current_device()
    for form in range(len(Q.GEMV_FORMS)):
        for mt in (1, 2, 4, 8):
            assert Q.gemv_attributes(form, mt, 128)[5] % 32 == 0

    def split(m, k, n, planes, form):
        mt, ksplit, per = Q.gemv_plan(index, form, m, k, n, 1, planes)
        stage = Q.gemv_attributes(form, mt, 1)[5]
        assert per % stage == 0
        assert ksplit * per >= k // planes > (ksplit - 1) * per
        return ksplit

    for k, n in ((4096, 4096), (4096, 1024), (14336, 4096)):
        assert split(8, k, n, 2, 1) > 1
    assert split(8, 4096, 128256, 1, 0) == 1
    assert split(8, 256, 512, 2, 1) == 1
    assert split(64, 4096, 14336, 2, 1) == 1


def test_gemv_rejects_split_off_stage(dev):
    """The C entry refuses a split that is not whole stages or does not
    cover the packed rows once (the host's tables and the kernel's stage
    rows would have drifted), and takes the chooser's."""
    from piquant_tpu_torch.ops.cuda import _build

    m, k, n = 8, 4096, 1024
    x = torch.zeros((m, k), dtype=torch.bfloat16, device=dev)
    data = torch.zeros((k // 2, n), dtype=torch.uint8, device=dev)
    scale = torch.ones(n, device=dev)
    zp = torch.zeros(n, dtype=torch.int32, device=dev)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    _, ksplit, per = Q.gemv_plan(torch.cuda.current_device(), 1, m, k, n, 1,
                                 2)

    def launch(ks, rows):
        return _build.library().pq_w4_gemv(
            x.data_ptr(), data.data_ptr(), scale.data_ptr(), zp.data_ptr(),
            None, out.data_ptr(), m, k, n, ks, rows, 1, _build.stream_ptr(x))

    assert launch(ksplit, per) == 0
    torch.cuda.synchronize()
    assert launch(ksplit, per + 16) != 0      # not whole stages (>= 32 rows)
    assert launch(ksplit + 1, per) != 0       # a split with no rows
    assert ksplit > 1 and launch(1, per) != 0   # rows left uncovered


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
@pytest.mark.parametrize("m", GEMV_M)
@pytest.mark.parametrize("bits,k,n", [(8, 512, 384), (8, 4096, 128256),
                                      (2, 512, 384), (2, 4096, 1024),
                                      (2, 14336, 4096)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("given", [True, False])
def test_channel_gemv_matches_plain(dev, m, bits, k, n, out_dtype, given):
    """xsum given (the caller's row sums) or None (the dispatch's call: the
    kernel sums its staged x, for INT8 with the zp - 128 fold)."""
    ql = _qlin(dev, k, n, bits, None, k + n)
    x = _x(dev, m, k, m)
    xsum = x.float().sum(1, keepdim=True) if given else None
    s, z = ql.scale.reshape(-1).contiguous(), ql.zero_point.reshape(-1).contiguous()
    kern, plain = ((Q.w8_gemv, Q.w8_gemv_plain) if bits == 8
                   else (Q.w2_gemv, Q.w2_gemv_plain))
    before = kern.launches
    got = kern(x, ql.data, s, z, xsum, out_dtype).float()
    assert kern.launches == before + 1
    want = plain(x, ql.data, s, z, xsum, out_dtype).float()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=1e-2)


@pytest.mark.parametrize("m", GEMV_M)
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


@pytest.mark.parametrize("m", GEMV_M)
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
@pytest.mark.parametrize("m", GEMV_M)
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
# decode tiles (16, 64 rows), the prefill tile (128 or 256 tokens) and
# their ragged edges; the small weights at small M and N 1024 at M 1024
# (INT2, INT4, INT8) split K over blocks, the large ones at M 1000 do not.
@pytest.mark.parametrize("m", [1, 8, 16, 17, 33, 64, 65, 127, 128, 129, 255,
                               256, 257, 1000, 1024, 2048])
@pytest.mark.parametrize("bits,k,n", [(4, 512, 256), (4, 4096, 1024),
                                      (4, 14336, 4096), (8, 512, 384),
                                      (8, 4096, 14336), (8, 4096, 1024),
                                      (2, 512, 384), (2, 4096, 1024),
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
@pytest.mark.parametrize("m", GEMV_M)
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
@pytest.mark.parametrize("rep", [1, 2, 3, 4, 5, 6, 7, 8])
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


def _decode_cache(dev, g, kv, nl, b, hkv, s, d):
    if kv == "kv4":
        return _kv4_cache(dev, g, nl, b, hkv, s, d)
    shape = (nl, b, hkv, s, d)
    kc, vc = (torch.randint(-127, 128, shape, generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(shape[:-1] + (1,), generator=g, device=dev) * 0.02
              for _ in range(2))
    return kc, ks, vc, vs


# Live windows whose ends lie on either side of a 64-position tile's edge
# and of a split's (the chooser's tiles a split times 64): the last or first
# position alone, 2 positions inside one split, 16 across a tile edge, 64
# on each side of a split edge, long windows from and to either side; on
# Llama-3-8B's decode grid (B 8, Hkv 8), a lone row (B * Hkv = 1) at D 256
# and at an S off the tile, and a wide batch; bounds as above.  (A window
# with only a few positions on one side of a split edge is left out: each
# split rounds its bf16 probabilities at its own maximum, as the reference
# kernel does at its 512-position chunk edges, and the plain version at the
# global one, so with cancelling codes a short sum can differ by one bf16
# ulp of a term, past atol 2e-3.)
@pytest.mark.parametrize("kv", ["kv8", "kv4"])
@pytest.mark.parametrize("b,hkv,rep,s,d", [
    (8, 8, 4, 2048, 128), (1, 1, 8, 2048, 256), (1, 1, 7, 1000, 128),
    (16, 8, 2, 4096, 128)])
def test_decode_attn2_split_edges(dev, kv, b, hkv, rep, s, d):
    g = _gen(dev, b * hkv + s + rep)
    kc, ks, vc, vs = _decode_cache(dev, g, kv, 2, b, hkv, s, d)
    kern = DA.decode_attn2_kv4 if kv == "kv4" else DA.decode_attn2
    q = torch.randn((b, hkv, rep, d), generator=g, device=dev)
    tps, _ = DA.split_tiles(s)
    e = tps * DA.TILE
    pairs = [(64, 63), (65, 64), (72, 56), (129, 64), (e, e - 1),
             (e + 1, e), (e + 64, e - 64), (e + 2, e), (e + 1, 65), (s, e),
             (s - 1, 1), (e - 1, 0), (s, 0), (2 * e + 1, e + 1)]
    for p_, s_ in pairs:
        p_, s_ = min(p_, s), min(s_, s)
        if p_ <= s_:
            continue
        pos = torch.full((b,), p_, dtype=torch.int32, device=dev)
        start = torch.full((b,), s_, dtype=torch.int32, device=dev)
        acc, m, l = kern(q, kc, ks, vc, vs, pos, start, d ** -0.5, 1)
        pacc, pm, pl = DA.decode_attn2_plain(q, kc, ks, vc, vs, pos, start,
                                             d ** -0.5, 1)
        torch.testing.assert_close(m, pm, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(l, pl, rtol=2e-2, atol=0)
        torch.testing.assert_close(acc / l, pacc / pl, atol=2e-3, rtol=2e-2)


# Two calls on the same inputs, then a CUDA graph of one call replayed
# twice, give identical bits in all three forms (the split partials are
# merged in split order, never in arrival order), and every call leaves
# the ticket buffer zeroed for the next.  B * Hkv = 4 at S 4096: 64
# one-tile splits a row.
@pytest.mark.parametrize("form", ["kv8", "kv4", "v1"])
def test_decode_attn2_repeatable(dev, form):
    g = _gen(dev, 41)
    b, hkv, rep, s, d = 2, 2, 8, 4096, 256
    kc, ks, vc, vs = _decode_cache(dev, g, "kv4" if form == "kv4" else "kv8",
                                   2, b, hkv, s, d)
    q = torch.randn((b, hkv, rep, d), generator=g, device=dev).to(
        torch.bfloat16)
    pos = torch.tensor([s, 3001], dtype=torch.int32, device=dev)
    start = torch.tensor([0, 5], dtype=torch.int32, device=dev)
    if form == "v1":
        call = lambda: (AT.decode_attn(  # noqa: E731
            q, kc[1], ks[1], vc[1], vs[1], pos - 1, d ** -0.5),)
    else:
        kern = DA.decode_attn2_kv4 if form == "kv4" else DA.decode_attn2
        call = lambda: kern(q, kc, ks, vc, vs, pos, start,  # noqa: E731
                            d ** -0.5, 1)
    first = [x.clone() for x in call()]
    second = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append([x.clone() for x in out])
    for got in (second, *replays):
        assert all(torch.equal(x, y) for x, y in zip(got, first))
    assert int(_build.tickets(q.device, b * hkv).abs().sum()) == 0


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
    with pytest.raises(NotImplementedError, match="queue 2 item 3"):
        kc3, ks3, vc3, vs3 = _kv4_cache(dev, g, 1, 1, 1, 256, 384)
        DA.decode_attn2_kv4(torch.zeros((1, 1, 2, 384), device=dev), kc3,
                            ks3, vc3, vs3, pos, pos, 1.0, 0)   # head_dim 384


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
    the decode kernel swapped for its plain version, and against the CPU
    (the plain versions throughout).

    kv4 held the CPU bound only once the cache scales became IEEE
    quotients on the card (0.0282 from the CPU before, 0.0087 after, on an
    H100).  The test prints the codes that differ between the two
    prefilled caches and the three readings."""
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
    versions, and against the CPU (kv4 since its scales are IEEE quotients
    on the card).
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
    with pytest.raises(ValueError):                   # 2 kv heads for 1
        DA.decode_attn2(q.expand(1, 2, 9, 128), kc, ks, kc, ks, pos, pos,
                        1.0, 0)
    with pytest.raises(NotImplementedError,           # head_dim 384
                       match="queue 2 item 3"):
        DA.decode_attn2(torch.zeros((1, 1, 2, 384), device=dev),
                        torch.zeros((1, 1, 1, 256, 384), dtype=torch.int8,
                                    device=dev), ks, kc, ks, pos, pos, 1.0, 0)


# Output element by element within atol 2e-3, rtol 2e-2 (bf16
# probabilities before PV in both; another tile order for the online
# softmax).  The kernel's blocks hold the rep heads of one kv head times
# 128 // rep positions: T of 1, 17, 64, 127, 129 and 255 put positions
# either side of each block edge at every rep, and the last block ragged.
@pytest.mark.parametrize("rep,t", [(1, 256), (2, 384), (4, 200), (8, 128),
                                   (3, 256), (5, 128), (6, 384), (7, 200)] +
                         [(rep, t) for rep in range(1, 9)
                          for t in (1, 17, 64, 127, 129, 255)])
def test_flash_matches_plain(dev, rep, t):
    g = _gen(dev, rep * t)
    b, hkv, d = 2, 2, 128
    q = torch.randn((b, hkv, rep, t, d), generator=g, device=dev)
    k = torch.randn((b, hkv, t, d), generator=g, device=dev)
    v = torch.randn((b, hkv, t, d), generator=g, device=dev)
    before = FL.flash_attn.launches
    got = FL.flash_attn(q, k, v, d ** -0.5)
    assert FL.flash_attn.launches == before + 1
    want = FL.flash_attn_plain(q, k, v, d ** -0.5)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-2)


# The sliding window as flash_attn_plain takes it, at every rep: windows of
# 1 (the diagonal alone), 63 and 100 (not multiples of the 64-key tile),
# 127 and 129 (either side of the 128-key tile), 200 and one wider than T
# (the causal mask); T of whole 128-row tiles and ragged.  Bounds as above.
@pytest.mark.parametrize("rep", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("window,t", [(1, 256), (63, 384), (100, 200),
                                      (127, 384), (129, 300), (200, 512),
                                      (1000, 256)])
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
# tiles and ragged, at the Gemma reps and the odd ones (a 128-row block
# holds 126 rows at rep 3, 6 and 7, 125 at rep 5).  Unit-normal scores
# (scale d^-0.5; a cap of 2 bites there) within the bounds above.  Peaked
# scores (q and k doubled at Gemma-2's scale 1/16: a spread of 2.8 at D 128,
# 4 at D 256) let a few keys dominate a row, and one bf16 rounding of a
# dominant probability moves the context past atol 2e-3: there the kernel
# stays within one rounding (`rounding_bound`, and 1e-4 for the f32 sums)
# of the context with unrounded probabilities, and within the stated bound
# plus two roundings of the plain version, which rounds against the row's
# max where the kernel rounds against the running one.
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("rep", [1, 2, 3, 5, 6, 7, 8])
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
# boundary falls inside a 16-row warp; pos0 56 and 30 put boundaries of
# chunks 96 and 100 at positions 40 and 70, inside the first and the
# second 64-row warpgroup at rep 1 and inside both at rep 2) and GPT-OSS's
# sinks (N(0, 1), the first query head's lifted by 3 so the sink dominates
# some rows), in every combination with each other, the window (63) and
# the softcap (2), at D 128 and 256, T of whole tiles and ragged, reps 1-3
# and 5-8.  Chunk starts leave a row few live keys, where one bf16
# rounding of a dominant probability moves the context past atol 2e-3 (as
# under peaked scores above): the kernel stays within the stated bound
# plus two roundings of the plain version (`rounding_bound`).  Every sink
# moves the context beyond that bound.
FLASH_MODES = {
    "chunk": dict(chunk=96), "chunk_pos0": dict(chunk=96, pos0=(40, 1000)),
    "chunk_wg0": dict(chunk=96, pos0=(56, 3)),
    "chunk_wg1": dict(chunk=100, pos0=(30, 0)),
    "sinks": dict(sinks=True), "sinks_window": dict(sinks=True, window=63),
    "sinks_chunk": dict(sinks=True, chunk=96, pos0=(40, 1000)),
    "sinks_softcap": dict(sinks=True, softcap=2.0),
    "chunk_softcap": dict(chunk=96, pos0=(40, 1000), softcap=2.0),
    "all_but_window": dict(sinks=True, chunk=96, pos0=(7, 0), softcap=2.0),
    "sinks_window_softcap": dict(sinks=True, window=63, softcap=2.0)}


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("rep", [1, 2, 3, 5, 6, 7, 8])
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


# A negative scale and a zero one (every score 0) as the plain version
# takes them, causal and under a softcap.
@pytest.mark.parametrize("sm", [-128 ** -0.5, 0.0])
@pytest.mark.parametrize("softcap", [None, 2.0])
def test_flash_nonpositive_scale_matches_plain(dev, sm, softcap):
    g = _gen(dev, 7)
    q = torch.randn((2, 2, 4, 200, 128), generator=g, device=dev)
    k = torch.randn((2, 2, 200, 128), generator=g, device=dev)
    v = torch.randn((2, 2, 200, 128), generator=g, device=dev)
    before = FL.flash_attn.launches
    got = FL.flash_attn(q, k, v, sm, softcap=softcap)
    assert FL.flash_attn.launches == before + 1
    want = FL.flash_attn_plain(q, k, v, sm, softcap=softcap)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-2)


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
    with pytest.raises(ValueError):                   # k of 2 kv heads
        FL.flash_attn(torch.zeros((1, 1, 9, 128, 128), device=dev),
                      torch.zeros((1, 2, 128, 128), device=dev),
                      torch.zeros((1, 2, 128, 128), device=dev), 1.0)
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
# scales on the card: IEEE quotients
# ---------------------------------------------------------------------------

# The kv8 / kv4 cache scales and the int8 activation scales on the card
# equal numpy's f32 amax / q bit for bit over 10^5 rows of amax in [0, 8)
# (PyTorch multiplies a CUDA tensor by the reciprocal of a Python divisor).
@pytest.mark.parametrize("which,q", [("kv8", 127), ("kv4", 7), ("act", 127)])
def test_scale_is_ieee_quotient_on_card(dev, which, q):
    import numpy as np

    from piquant_tpu_torch.quant import kv_cache as KV
    from piquant_tpu_torch.quant.linear import _quantize_act

    x = np.random.default_rng(q).uniform(-8, 8, (100_000, 8)).astype(
        np.float32)
    xt = torch.from_numpy(x).to(dev)
    if which == "act":
        _, got = _quantize_act(xt)
    else:
        _, got = KV._quantize_sym(xt, 8 if which == "kv8" else 4)
    want = np.maximum(np.abs(x).max(-1, keepdims=True), np.float32(1e-8)) \
        / np.float32(q)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.int32),
                                  want.view(np.int32))


# ---------------------------------------------------------------------------
# ragged MoE expert GEMMs (csrc/qmatmul_ragged.cu, csrc/qmatmul_a8.cu)
# ---------------------------------------------------------------------------

def _routed_x(dev, e, k, ntok, skew, seed):
    """x [m_pad, k] bf16 sorted and padded by a routing of ntok tokens, and
    its block_expert.  skew "random": top 2 of random logits; "zero":
    expert 0 gets no token and expert 1 nearly all; "all": every token
    goes to expert 1 alone (top 1), the tail blocks to the last expert;
    "sparse": top 2 of experts 0-7 only (the others get no token)."""
    from piquant_tpu_torch.quant import moe as MO

    g = _gen(dev, seed)
    logits = torch.randn((ntok, e), generator=g, device=dev)
    if skew == "zero":
        logits[:, 0] -= 50
        logits[:, 1] += 3
    if skew == "sparse":
        logits[:, 8:] -= 50
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
# sums in another order, one bf16 output rounding).  The padding rows come
# out exactly zero: inside the live blocks computed, past live_blocks
# written as zeros.  The tile's edges: (K/P) % 64 == 32 (K 576), N 384,
# group sizes 8 (off the k16 steps), 16, 32, 48, 64 and 128, 128 experts
# of which most have no token.
@pytest.mark.parametrize("skew", ["random", "zero", "all"])
@pytest.mark.parametrize("bits,gs,e,k,n", [
    (4, None, 4, 512, 256), (2, None, 8, 1024, 384), (8, None, 4, 512, 128),
    (4, 128, 8, 4096, 256), (2, 32, 4, 1024, 256), (4, 16, 4, 512, 256),
    (8, 64, 4, 512, 128), (4, None, 4, 576, 384), (2, None, 4, 1152, 128),
    (8, None, 4, 544, 256), (4, 32, 4, 576, 384), (4, 64, 4, 1024, 384),
    (4, 48, 4, 768, 256), (4, 8, 4, 512, 128), (2, 16, 4, 1024, 128),
    (8, 128, 4, 1024, 256)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_ragged_matches_plain(dev, skew, bits, gs, e, k, n, out_dtype):
    _hold_ragged(dev, skew, bits, gs, e, k, n, out_dtype, 300)


@pytest.mark.parametrize("bits,gs", [(4, None), (2, None), (8, None),
                                     (4, 128), (2, 32), (4, 16)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_ragged_matches_plain_128_experts(dev, bits, gs, out_dtype):
    _hold_ragged(dev, "sparse", bits, gs, 128, 256, 128, out_dtype, 300)


def _hold_ragged(dev, skew, bits, gs, e, k, n, out_dtype, ntok):
    from piquant_tpu_torch.ops.cuda import ragged as R

    st = _stack(dev, e, k, n, bits, gs, k + n + bits)
    x, r = _routed_x(dev, e, k, ntok, skew, e + k)
    counts = torch.bincount(r.block_expert.long()[r.dest // R.ROW_BLOCK],
                            minlength=e)
    live = int(((counts + R.ROW_BLOCK - 1) // R.ROW_BLOCK).sum())
    assert int(r.live_blocks) == live < x.shape[0] // R.ROW_BLOCK
    kern = R.wq_ragged_grouped if gs else R.wq_ragged
    before = kern.launches
    got = R.wq_ragged_matmul(x, st, r.block_expert, out_dtype, r.live_blocks)
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
# epilogue unfused in the reference's order).  With the routing's
# live_blocks and every padding row of xq filled with nonzero codes, the
# rows past live_blocks come out zero from both: a kernel that computed
# those blocks would write nonzero rows there.
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
    s, zs = R._channel_side(st)
    before = R.wq_ragged_a8.launches
    got = R.wq_ragged_matmul_a8(xq, xs, st, r.block_expert, out_dtype)
    assert R.wq_ragged_a8.launches == before + 1
    want = R.wq_ragged_a8_plain(xq, xs, st.data, s, zs,
                                xq.float().sum(1, keepdim=True),
                                r.block_expert, out_dtype)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert not got[_pad_rows(r, x.shape[0])].any()

    xq[_pad_rows(r, x.shape[0])] = 5
    tail = int(r.live_blocks) * R.ROW_BLOCK
    got = R.wq_ragged_matmul_a8(xq, xs, st, r.block_expert, out_dtype,
                                r.live_blocks)
    want = R.wq_ragged_a8_plain(xq, xs, st.data, s, zs,
                                xq.float().sum(1, keepdim=True),
                                r.block_expert, out_dtype, r.live_blocks)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert not got[tail:].any() and not want[tail:].any()
    if skew != "all":               # "all": every block is live
        assert tail < x.shape[0]


def _replays(fn):
    """fn() captured in a CUDA graph (after one eager call) and replayed
    twice: the two outputs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    return first, out.clone()


# Two calls, and two replays of a CUDA graph, give the same bits: at a K
# split of the prefill tile (N 1024 at M 1024: four splits' int32 partials
# summed by a second pass) and at a ragged shape.
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_a8_repeats_bit_for_bit(dev, bits):
    from piquant_tpu_torch.ops.cuda import ragged as R
    from piquant_tpu_torch.quant.linear import _quantize_act

    name, planes = A8[bits]
    kern = getattr(Q, name)
    ops = _a8_inputs(dev, 1024, 4096, 1024, bits, 11)
    assert Q.a8_split(1024, 4096, 1024, 132, planes)[1] > 1
    calls = [kern(*ops, torch.bfloat16) for _ in range(2)]
    assert torch.equal(calls[0], calls[1])
    assert torch.equal(calls[0], getattr(Q, name + "_plain")(*ops,
                                                             torch.bfloat16))
    for out in _replays(lambda: kern(*ops, torch.bfloat16)):
        assert torch.equal(out, calls[0])
    if bits == 8:
        return
    st = _stack(dev, 8, 4096, 1024, bits, None, 12)
    x, r = _routed_x(dev, 8, 4096, 1024, "zero", 13)
    xq, xs = _quantize_act(x)

    def ragged():
        return R.wq_ragged_matmul_a8(xq, xs, st, r.block_expert,
                                     torch.float32, r.live_blocks)

    first = ragged()
    assert torch.equal(first, ragged())
    for out in _replays(ragged):
        assert torch.equal(out, first)


def _gemv_calls(dev):
    """(name, call) of each GEMV entry point at Llama-3-8B's wk (K 4096, N
    1024, M 8: K split over a cluster, merged in the launch), w4_gemv also
    at K 256 (no split), and the dispatch of a channelwise INT4 weight
    (which no longer sums x in launches of its own)."""
    from piquant_tpu_torch.quant.linear import (_quantize_act,
                                                grouped_chunk_factor)

    x = _x(dev, 8, 4096, 21)
    xq, xs = _quantize_act(x)
    bf = torch.bfloat16
    calls = []

    def channel(name, bits, k, n, seed):
        ql = _qlin(dev, k, n, bits, None, seed)
        s = ql.scale.reshape(-1).contiguous()
        z = ql.zero_point.reshape(-1).contiguous()
        xx = x[:, :k].contiguous()
        return (f"{name} K={k}",
                lambda: getattr(Q, name)(xx, ql.data, s, z, None, bf))

    calls.append(channel("w4_gemv", 4, 4096, 1024, 31))
    calls.append(channel("w4_gemv", 4, 256, 512, 32))
    calls.append(channel("w8_gemv", 8, 4096, 1024, 33))
    calls.append(channel("w2_gemv", 2, 4096, 1024, 34))
    for bits, gs in ((4, 128), (2, 32)):
        ql = _qlin(dev, 4096, 1024, bits, gs, 40 + bits)
        ch = grouped_chunk_factor(4096, gs, Q.PLANES[bits])
        calls.append((f"wg_chunk INT{bits}", lambda ql=ql, gs=gs, ch=ch:
                      Q.wg_chunk(x, ql.data, ql.s_chunk, ql.z_chunk, gs, ch,
                                 bf)))
        calls.append((f"wg_chunk int8-x INT{bits}", lambda ql=ql, gs=gs, ch=ch:
                      Q.wg_chunk(xq, ql.data, ql.s_chunk, ql.z_chunk, gs, ch,
                                 bf, xs)))
    qg = _qlin(dev, 4096, 1024, 4, 256, 50)
    calls.append(("w4_grouped", lambda: Q.w4_grouped(
        x, qg.data, qg.scale, qg.zero_point, 256, bf)))
    for gs in (None, 128):
        qn = _qlin(dev, 4096, 1024, "nf4", gs, 60 + (gs or 0))
        scale = (qn.scale if gs else qn.scale.reshape(-1)).contiguous()
        calls.append((f"nf4_gemv gs={gs}", lambda qn=qn, gs=gs, scale=scale:
                      Q.nf4_gemv(x, qn.data, scale, gs or 0, bf)))
    q4 = _qlin(dev, 4096, 1024, 4, None, 70)
    calls.append(("quantized_matmul INT4", lambda: Q.quantized_matmul(x, q4)))
    return calls


# Two calls, and two replays of a CUDA graph, give the same bits: the
# cluster's blocks add their partial sums in split order.
def test_gemv_repeats_bit_for_bit(dev):
    for name, call in _gemv_calls(dev):
        first = call()
        assert torch.equal(first, call()), name
        for out in _replays(call):
            assert torch.equal(out, first), name


# One wrapper call is one kernel launch, with the K split merged in it (no
# second pass, no row-sum launches).
def test_gemv_one_launch(dev):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name, call in _gemv_calls(dev):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        assert len(kernels) == 1, (name, kernels)
        assert "gemv_tc" in kernels[0], (name, kernels)


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
    with pytest.raises(TypeError):                    # live_blocks not [1]
        R.wq_ragged(x, st.data, s, zs, xsum, be, torch.bfloat16, be)
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


# ---------------------------------------------------------------------------
# the fused MLP (row 23) and the first flash-decode kernel (row 24)
# ---------------------------------------------------------------------------

from piquant_tpu_torch.ops.cuda import attention as AT  # noqa: E402


def _mlp_operands(dev, g, m, k, i_ff, n):
    """Random split-half codes with a scale and zero point per column (zero
    points over 0-15, so a dropped fold shows) and x, xsum."""
    def side(cols, s):
        return (torch.rand(cols, generator=g, device=dev) * s + s / 2,
                torch.randint(0, 16, (cols,), generator=g, device=dev,
                              dtype=torch.int32))

    w13 = torch.randint(0, 256, (k // 2, 2 * i_ff), generator=g, device=dev,
                        dtype=torch.uint8)
    w2 = torch.randint(0, 256, (i_ff // 2, n), generator=g, device=dev,
                       dtype=torch.uint8)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    return (x, w13, *side(2 * i_ff, 0.1 / k ** 0.5), w2,
            *side(n, 0.1 / i_ff ** 0.5), x.float().sum(1, keepdim=True))


# the shapes of chip_smoke.py phase 14 (a): Llama-3-8B's MLP (SiLU) and
# Gemma-7B's (GeGLU) at M 8, 1, 33, 64, a small one, and one whose last
# 256-column output tile holds 128 columns; GEMV tolerance
@pytest.mark.parametrize("k,i_ff,n,act", [(4096, 14336, 4096, "silu"),
                                          (3072, 24576, 3072, "gelu"),
                                          (512, 1024, 512, "silu"),
                                          (768, 1536, 384, "gelu")])
@pytest.mark.parametrize("m", [8, 1, 33, 64])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("given", [True, False])
def test_mlp_fused_matches_plain(dev, k, i_ff, n, act, m, out_dtype, given):
    """The caller's row sums of x (given) or none (the dispatch's call: the
    kernel sums its staged x) against the plain version with the sums."""
    ops = _mlp_operands(dev, _gen(dev, m + k), m, k, i_ff, n)
    call = ops if given else ops[:-1] + (None,)
    before = Q.mlp_fused.launches
    got = Q.mlp_fused(*call, act, out_dtype)
    again = Q.mlp_fused(*call, act, out_dtype)
    assert Q.mlp_fused.launches == before + 2
    assert torch.equal(got, again)          # fixed summation order
    want = Q.mlp_fused_plain(*ops, act, out_dtype)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=1e-2)


# Stage B in one-stage splits of one output tile each, so a block's ring
# holds stages of several splits.  With a few more blocks than A items,
# blocks take B items while every A item runs at once, so the splits' h
# completes in no fixed order; with 3 blocks, A and B meet at the end of
# stage A.  Every free block of the h scratch's size is filled with NaN
# before each call, so an h box read before stage A wrote it shows.
@pytest.mark.parametrize("m", [1, 8, 64])
@pytest.mark.parametrize("extra", [-61, 2, 6])
def test_mlp_fused_short_splits(dev, monkeypatch, m, extra):
    k, i_ff, n = 4096, 8192, 256
    mt = Q.mlp_plan(dev.index or 0, m, k, i_ff, n)[0]
    att = Q.mlp_attributes(mt, dev.index)
    stage, blocks = att[4], i_ff // 128 + extra
    ksb = i_ff // 2 // stage
    assert ksb > att[3] and blocks <= _build.sm_count(dev.index or 0)
    monkeypatch.setattr(Q, "mlp_plan", lambda *a: (mt, blocks, ksb, stage))
    g = _gen(dev, m + blocks)
    ops = _mlp_operands(dev, g, m, k, i_ff, n)
    for _ in range(24):
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        want = Q.mlp_fused_plain(x, *ops[1:7], None, "silu", torch.float32)
        poison = [torch.full((m, i_ff), float("nan"), dtype=torch.bfloat16,
                             device=dev) for _ in range(8)]
        del poison                      # every free block of h's size
        got = Q.mlp_fused(x, *ops[1:7], None, "silu", torch.float32)
        torch.testing.assert_close(got, want, atol=2e-2, rtol=1e-2)


@pytest.mark.parametrize("k,i_ff,n", [(4096, 14336, 4096),
                                      (3072, 24576, 3072), (512, 1024, 512),
                                      (768, 1536, 384)])
@pytest.mark.parametrize("m", [1, 8, 64])
def test_mlp_queue_matches_kernel(dev, k, i_ff, n, m):
    """The planner's model of the work queue (mlp_queue) is the kernel's
    (pq_mlp_queue): the items in claim order and each split's A items, at
    the plan's split and at one-stage splits."""
    import ctypes

    mt, _, ksb, rows_b = Q.mlp_plan(dev.index or 0, m, k, i_ff, n)
    stage = Q.mlp_attributes(mt, dev.index)[4]
    for rb in (rows_b, stage):
        kb = -(-(i_ff // 2) // rb)
        want = Q.mlp_queue(k, i_ff, n, rb)
        out = (ctypes.c_int * (5 * len(want) + kb))()
        assert _build.library().pq_mlp_queue(k, i_ff, n, kb, rb,
                                             out) == len(want)
        got = [tuple(out[5 * i: 5 * i + 5]) for i in range(len(want))]
        assert got == [(0, t, r1, q0, q1) if kind == "A" else
                       (1, t, r0, r1, q0)
                       for kind, t, r0, r1, q0, q1 in want]
        assert list(out[5 * len(want):]) == [
            sum(1 for it in want if it[0] == "A" and it[4] <= q <= it[5])
            for q in range(kb)]


def test_mlp_fused_one_launch(dev, monkeypatch):
    """The dispatch's fused-MLP call is one kernel: no cast or row-sum
    launch before it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from piquant_tpu_torch.quant.linear import quantize_linear_weight

    monkeypatch.setenv("PIQUANT_MLP_FUSE", "1")
    g = _gen(dev, 3)
    w13 = quantize_linear_weight(torch.randn(512, 2048, generator=g,
                                             device=dev) * 0.05, 4)
    w2 = quantize_linear_weight(torch.randn(1024, 512, generator=g,
                                            device=dev) * 0.05, 4)
    x = torch.randn((1, 8, 512), generator=g, device=dev).to(torch.bfloat16)
    y = Q.mlp_fused_matmul(x, w13, w2, "silu")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y2 = Q.mlp_fused_matmul(x, w13, w2, "silu")
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "mlp_tc" in kernels[0], kernels
    assert torch.equal(y, y2)


def test_mlp_fused_refuses(dev):
    ops = list(_mlp_operands(dev, _gen(dev, 1), 8, 512, 1024, 512))
    with pytest.raises(ValueError, match="unsupported shape"):
        Q.mlp_fused(ops[0][:, :256].contiguous(), *ops[1:], "silu",
                    torch.float32)
    with pytest.raises(ValueError, match="unsupported shape"):
        Q.mlp_fused(torch.zeros((65, 512), dtype=torch.bfloat16, device=dev),
                    *ops[1:7], torch.zeros((65, 1), device=dev), "silu",
                    torch.float32)
    with pytest.raises(ValueError):
        Q.mlp_fused(*ops, "relu", torch.float32)
    with pytest.raises(TypeError):
        Q.mlp_fused(ops[0].float(), *ops[1:], "silu", torch.float32)


def _v1_cache(dev, g, b, hkv, s, d, peaked=False):
    kc, vc = (torch.randint(-127, 128, (b, hkv, s, d), generator=g,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((b, hkv, s, 1), generator=g, device=dev) * 0.02
              for _ in range(2))
    if peaked:      # one key dominates some rows
        ks[:, :, 5] = 0.5
    return kc, ks, vc, vs


# B 8, Hkv 8, rep 4, S 2048 (Llama-3-8B's decode, phase 14 (a)); every rep
# at head_dim 128 and 256; S below one kernel chunk; positions 0 (one live
# key), S - 1 and a chunk wholly past pos; atol 2e-3, rtol 2e-2 as the other
# attention holds
@pytest.mark.parametrize("b,hkv,rep,s,d", [
    (8, 8, 4, 2048, 128), (2, 2, 1, 512, 128), (2, 2, 3, 1024, 128),
    (2, 2, 5, 1536, 128), (2, 1, 7, 512, 128), (2, 2, 8, 2048, 128),
    (2, 16, 1, 2048, 256), (2, 1, 8, 2048, 256), (2, 2, 4, 256, 256),
    (3, 2, 2, 64, 128), (2, 2, 6, 1024, 128), (2, 1, 2, 2048, 256),
    (2, 1, 3, 1024, 256), (2, 2, 5, 512, 256), (2, 1, 6, 2048, 256),
    (2, 1, 7, 1024, 256)])
@pytest.mark.parametrize("peaked", [False, True])
def test_decode_attn_matches_plain(dev, b, hkv, rep, s, d, peaked):
    g = _gen(dev, b * s + rep + d)
    kc, ks, vc, vs = _v1_cache(dev, g, b, hkv, s, d, peaked)
    q = torch.randn((b, hkv, rep, d), generator=g, device=dev).to(
        torch.bfloat16)
    pos = torch.randint(0, s, (b,), generator=g, device=dev,
                        dtype=torch.int32)
    pos[0] = 0
    pos[1] = s - 1
    before = AT.decode_attn.launches
    got = AT.decode_attn(q, kc, ks, vc, vs, pos, d ** -0.5)
    assert AT.decode_attn.launches == before + 1
    want = AT.decode_attn_plain(q, kc, ks, vc, vs, pos, d ** -0.5)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-2)


def test_decode_attn_refuses(dev):
    g = _gen(dev, 3)
    kc, ks, vc, vs = _v1_cache(dev, g, 2, 2, 256, 128)
    q = torch.zeros((2, 2, 4, 128), dtype=torch.bfloat16, device=dev)
    pos = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="queue 2 item 3"):
        kc3, ks3, vc3, vs3 = _v1_cache(dev, g, 2, 2, 256, 384)
        AT.decode_attn(torch.zeros((2, 2, 9, 384), device=dev), kc3, ks3,
                       vc3, vs3, pos, 0.1)
    with pytest.raises(NotImplementedError, match="head_dim"):
        AT.decode_attn(torch.zeros((2, 2, 4, 64), device=dev), kc[..., :64],
                       ks, vc[..., :64], vs, pos, 0.1)
    with pytest.raises(TypeError):
        AT.decode_attn(q, kc.to(torch.uint8), ks, vc, vs, pos, 0.1)
    with pytest.raises(ValueError):
        AT.decode_attn(q, kc[:, :, :128], ks, vc, vs, pos, 0.1)


# The ring's hop and gather kernels against the whole ring's plain version,
# bit for bit (no FMA, IEEE division, half to even in both): stacked ranks
# on the card, full and ragged buckets, misaligned rows (scalar loads), the
# P = 2 loopback and padding-only chunks; a second segment whose wire
# offset is 4-byte but not 16-byte aligned (14336 at max_chunk 1024, P 4
# and 8); chunks past the on-chip capacity (max_chunk 262144: the two-pass
# path, with a ragged tail that takes the on-chip path, or at P 2 and 4 a
# ragged tail past it too, 16-byte and scalar x rows); a gather over many
# runs of 512 tiles with a ragged last run (8 * 65536 * 17 + 12345).
@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("n,max_chunk", [(4096, 65536), (1000, 65536),
                                         (16 * 257, 65536),
                                         (3 * 8 * 1024 + 7, 1024),
                                         (5 * 4 * 2048, 2048),
                                         (14336, 1024),
                                         (65536, 32768),
                                         (2 * 262144 + 5000, 262144),
                                         (2 * 262144 + 300007, 262144),
                                         (8 * 65536 * 17 + 12345, 65536)])
def test_ring_kernels_match_plain(dev, p, n, max_chunk):
    from piquant_tpu_torch.parallel import make_mesh, rdma_all_reduce_shard

    x = torch.randn((p, n), generator=_gen(dev, p * n), device=dev)
    axis = make_mesh([("x", p)], devices=[dev] * p).axis("x")
    hops, gathers = RG.ring_hop.launches, RG.ring_gather.launches
    got = rdma_all_reduce_shard(x, axis, max_chunk_elems=max_chunk)
    segs, _ = RG.segments(n, p, max_chunk)
    assert RG.ring_hop.launches - hops == p * len(segs)
    assert RG.ring_gather.launches - gathers == len(segs)
    torch.cuda.synchronize()
    want = RG.ring_plain(x, max_chunk)
    assert torch.equal(got, want)
    for d in range(1, p):
        assert torch.equal(got[0], got[d])


def _group_form(x, segs, p, nbytes):
    """The process-group form's kernels on one card: at every hop each
    rank's `ring_hop` is its own launch (rows 1, my0 r) reading its left
    neighbour's send row, then each rank's `ring_gather` (nrep 1) of the
    owners' rows.  Returns the send rows after every hop and the replicas."""
    sends = torch.empty((p, p, nbytes), dtype=torch.uint8, device=x.device)
    for hop in range(p):
        for r in range(p):
            left = (r - 1) % p
            for seg in segs:
                RG.ring_hop(x[r:r + 1], seg, p, hop, sends[hop, r:r + 1],
                            None if hop == 0 else sends[hop - 1, left:left + 1],
                            r)
    out = torch.empty_like(x)
    for r in range(p):
        for seg in segs:
            RG.ring_gather(sends[p - 1], seg, p, out[r:r + 1])
    return sends, out


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("n,max_chunk", [(16 * 257, 65536),
                                         (3 * 8 * 1024 + 7, 1024),
                                         (14336, 1024),
                                         (8 * 65536 * 2 + 4096, 65536),
                                         (2 * 262144 + 5000, 262144)])
def test_ring_group_form_matches_stacked(dev, p, n, max_chunk):
    """Each rank's hop as its own launch (the process-group form) writes
    the stacked launch's send rows bit for bit at every hop, and its
    replicas equal ring_plain's."""
    x = torch.randn((p, n), generator=_gen(dev, p + n), device=dev)
    segs, nbytes = RG.segments(n, p, max_chunk)
    sends, out = _group_form(x, segs, p, nbytes)
    bufs = torch.empty((p, p, nbytes), dtype=torch.uint8, device=dev)
    for hop in range(p):
        for seg in segs:
            RG.ring_hop(x, seg, p, hop, bufs[hop],
                        None if hop == 0 else bufs[hop - 1], 0, 1)
    torch.cuda.synchronize()
    for hop in range(p):
        assert torch.equal(sends[hop], bufs[hop]), hop
    assert torch.equal(out, RG.ring_plain(x, max_chunk))


def test_ring_hop_repeats_bit_for_bit(dev):
    """The on-chip path's scale rests on every cluster block reading the
    same maximum after the cluster barrier: 50 launches of the w1-sized
    chunk at P = 8 (a cluster of 4 blocks a chunk) give the same wire rows
    as the first, and ring_hop_plain's."""
    p, n = 8, 8 * 65536 * 16
    x = torch.randn((p, n), generator=_gen(dev, 7), device=dev)
    segs, nbytes = RG.segments(n, p, 65536)
    assert RG.hop_plan(segs[0].csize).cluster > 1
    prev = torch.empty((p, nbytes), dtype=torch.uint8, device=dev)
    RG.ring_hop(x, segs[0], p, 0, prev)
    want = torch.empty_like(prev)
    RG.ring_hop_plain(x, segs[0], p, 1, want, prev, 0, 1)
    got = torch.empty_like(prev)
    for _ in range(50):
        got.zero_()
        RG.ring_hop(x, segs[0], p, 1, got, prev, 0, 1)
        assert torch.equal(got, want)


def _edge_chunks(gen):
    """Chunks of 1024 f32 that stress ring_hop's division and rounding:
    quotients exactly on half integers (scale 2^-3), scales at and past the
    [2^-100, 2^100] range of the reciprocal path, the 1e-30 floor with
    subnormal and tiny values, and an ordinary chunk."""
    def scaled(absmax):
        v = torch.rand(1024, generator=gen, dtype=torch.float64) * 2 - 1
        v[0] = 1.0
        return (v * absmax).float()

    half = (torch.arange(1024, dtype=torch.float64) % 254 - 127 + 0.5) / 8
    half[0], half[1] = 127 / 8, -127 / 8
    tiny = torch.tensor([1e-45, -1e-44, 3e-39, -1e-38, 1e-36, 0.0] * 170 +
                        [1e-36] * 4)
    return [half.float(), scaled(127 * 2.0 ** 100), scaled(127 * 2.0 ** 101),
            scaled(1e38), tiny.float(), scaled(1e-28), scaled(5e-29),
            scaled(2.5)]


@pytest.mark.parametrize("two_pass", [False, True])
def test_ring_hop_rounding_edges(dev, two_pass):
    """Each edge chunk as every rank's chunk of a hop at P = 2, with and
    without a received term, bit for bit against ring_hop_plain; on the
    on-chip path and on the two-pass path (chunks of 2 x ONCHIP_MAX values
    whose first 1024 are the edge chunk, the rest zeros)."""
    gen = torch.Generator().manual_seed(3)
    csize = 2 * RG.ONCHIP_MAX if two_pass else 1024
    assert (RG.hop_plan(csize).vals == 0) == two_pass
    for chunk in _edge_chunks(gen):
        x = torch.zeros((2, 2 * csize))
        x[0, :1024] = x[1, csize:csize + 1024] = chunk
        x[1, :1024] = x[0, csize:csize + 1024] = chunk.flip(0)
        x = x.to(dev)
        seg = RG.Segment(0, 1, csize, 2 * csize, 0)
        recv = torch.empty((2, seg.wire_bytes), dtype=torch.uint8,
                           device=dev)
        RG.ring_hop_plain(x, seg, 2, 0, recv)
        for hop, rv in ((0, None), (1, recv)):
            got = torch.empty_like(recv)
            want = torch.empty_like(recv)
            RG.ring_hop(x, seg, 2, hop, got, rv, 0, 1)
            RG.ring_hop_plain(x, seg, 2, hop, want, rv, 0, 1)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (float(chunk.abs().max()), hop)


def test_ring_selftest_and_refusals(dev):
    from piquant_tpu_torch.parallel import rdma_ring_selftest

    assert rdma_ring_selftest(rows=256) <= 0.1
    x = torch.zeros((2, 1024), device=dev)
    seg = RG.Segment(0, 1, 512, 1024, 0)
    send = torch.zeros((2, seg.wire_bytes), dtype=torch.uint8, device=dev)
    with pytest.raises(TypeError):
        RG.ring_hop(x.double(), seg, 2, 0, send)
    with pytest.raises(ValueError):
        RG.ring_hop(x, seg, 2, 0, send[:1])
    with pytest.raises(ValueError):
        RG.ring_hop(x, RG.Segment(0, 1, 510, 1020, 0), 2, 0, send)
    with pytest.raises(ValueError):
        RG.ring_gather(send[:1], seg, 2, x)
    odd = torch.zeros(2 * seg.wire_bytes + 1, dtype=torch.uint8,
                      device=dev)[1:].view(2, seg.wire_bytes)
    with pytest.raises(ValueError):    # wire rows not 4-byte aligned
        RG.ring_gather(odd, seg, 2, x)
    with pytest.raises(ValueError):
        RG.ring_hop(x, seg, 2, 0, odd)


# ---------------------------------------------------------------------------
# speculative decoding and requantize_params on the card
# ---------------------------------------------------------------------------

# Llama-3-8B's projections (K, N) and the rows a verify sends them at 8
# slots: M = 8 x (G + 1), G = 4 and 7 (the most at or under M_MAX = 64)
@pytest.mark.parametrize("m", [40, 64])
@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 1024), (4096, 14336),
                                 (14336, 4096)])
def test_w4_gemv_at_verify_rows(dev, m, k, n):
    g = _gen(dev, m + n)
    data = torch.randint(0, 256, (k // 2, n), generator=g, device=dev,
                         dtype=torch.uint8)
    scale = torch.rand(n, generator=g, device=dev) * 0.02 + 0.01
    zp = torch.randint(0, 16, (n,), generator=g, device=dev, dtype=torch.int32)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    before = Q.w4_gemv.launches
    got = Q.w4_gemv(x, data, scale, zp, None, torch.bfloat16).float()
    assert Q.w4_gemv.launches == before + 1
    want = Q.w4_gemv_plain(x, data, scale, zp, None, torch.bfloat16).float()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=1e-2)


def _spec_model():
    """A small head_dim-128 model (random INT4 codes, INT8 lm_head) whose
    every projection takes the GEMVs on the card."""
    from piquant_tpu_torch.models import llama as M

    cfg = M.LlamaConfig(vocab_size=256, d_model=256, n_layers=2, n_heads=2,
                        n_kv_heads=1, d_ff=512, max_seq_len=256)
    return cfg, M.random_quantized_params(cfg, 3, lm_head_bits=8,
                                          device="cpu")


def _spec_start(cfg, params, d, rows):
    """Prefill `rows` [B, T] on device d -> (tok, pos, cache, hist)."""
    from piquant_tpu_torch.models import llama as M

    b, t = rows.shape
    cache = M.init_kv_cache(cfg, b, max_len=128, device=d)
    logits, cache = M.prefill(cfg, params, rows.to(d), cache)
    tok = logits.argmax(-1).to(torch.int32)
    hist = torch.zeros((b, 128 + 6), dtype=torch.int32, device=d)
    hist[:, :t] = rows.to(d)
    hist[:, t] = tok
    return tok, torch.full((b,), t, dtype=torch.int32, device=d), cache, hist


def _emitted(out, b):
    """Each row's emitted tokens over the block's steps."""
    emit, _, n_emit = (t.cpu() for t in out[:3])
    return [[int(x) for k in range(emit.shape[0])
             for x in emit[k, i, :int(n_emit[k, i])]] for i in range(b)]


def test_spec_block_on_card_matches_cpu(dev):
    """spec_block at 8 rows x (G + 1) = 40 on the card (the GEMVs at M 40,
    the INT8 lm_head) against the same block on the CPU (the plain
    versions): each row's emitted tokens equal, or forking first where the
    CPU's top-2 margin, read by a full forward along its tokens, is under
    0.02 (tests/token_guard.py's near-tie guard)."""
    from piquant_tpu_torch.models import llama as M
    from piquant_tpu_torch.models import speculative as SP

    cfg, params = _spec_model()
    g = torch.Generator().manual_seed(4)
    seg = torch.randint(1, 256, (8, 12), generator=g, dtype=torch.int32)
    rows = torch.cat([seg, seg, seg], dim=1)        # bigrams recur
    rows[4:] = torch.randint(1, 256, (4, 36), generator=g, dtype=torch.int32)
    active = torch.ones(8, dtype=torch.bool)
    out = {}
    for d in ("cpu", dev):
        p = _to(params, d)
        tok, pos, cache, hist = _spec_start(cfg, p, d, rows)
        if d == "cpu":
            first = tok.clone()
        before = (Q.w4_gemv.launches, Q.w8_gemv.launches)
        out[d] = SP.spec_block(cfg, p, tok, pos, cache, hist, active.to(d),
                               6, 4)
        if d == dev:
            assert (Q.w4_gemv.launches - before[0],
                    Q.w8_gemv.launches - before[1]) == (7 * 2 * 6, 6)
    want, got = _emitted(out["cpu"], 8), _emitted(out[dev], 8)
    assert sum(len(w) for w in want) > 8 * 6, "no draft accepted"
    for i in range(8):
        if got[i] == want[i]:
            continue
        # the prompt, the prefill's token, then the emitted ones: emitted
        # token t is chosen by the logits at position len(prompt) + t
        seq = torch.cat([rows[i], first[i:i + 1],
                         torch.tensor(want[i][:-1], dtype=torch.int32)])
        lg, _ = M.forward(cfg, params, seq[None])
        t = next(j for j, (a, b) in enumerate(zip(got[i], want[i]))
                 if a != b)
        top = lg[0, rows.shape[1] + t].topk(2).values
        assert float(top[0] - top[1]) < 0.02, (i, t, got[i], want[i])


def test_spec_blocks_no_host_sync_on_card(dev):
    """Neither speculative block reads a tensor back to the host: a warm
    block runs under CUDA's sync debug mode, which raises at a sync."""
    from piquant_tpu_torch.models import llama as M
    from piquant_tpu_torch.models import speculative as SP

    cfg, params = _spec_model()
    p = _to(params, dev)
    rows = torch.randint(1, 256, (8, 36), generator=torch.Generator()
                         .manual_seed(5), dtype=torch.int32)
    active = torch.ones(8, dtype=torch.bool, device=dev)
    tok, pos, cache, hist = _spec_start(cfg, p, dev, rows)
    dcache = M.init_kv_cache(cfg, 8, max_len=128, device=dev)
    M.prefill(cfg, p, rows.to(dev), dcache)
    gen = _gen(dev, 6)
    temps = torch.full((8,), 0.9, device=dev)
    blocks = (
        lambda: SP.spec_block(cfg, p, tok, pos, cache, hist, active, 2, 4),
        lambda: SP.draft_spec_block(cfg, p, cfg, p, tok, pos, cache, dcache,
                                    active, 2, 4),
        lambda: SP.draft_spec_block_sample(cfg, p, cfg, p, tok, pos, cache,
                                           dcache, temps, gen, active, 2, 4))
    for block in blocks:
        block()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            block()
        finally:
            torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("bits,gs", [(2, None), (4, 32), (8, None),
                                     ("nf4", 64), (2, 32)])
def test_requantize_params_on_card_matches_cpu(dev, bits, gs):
    """requantize_params of a tiny MoE model with an INT8 lm_head on CUDA
    tensors: every field byte for byte the CPU's."""
    import dataclasses

    from piquant_tpu_torch.models import llama as M

    cfg = M.LlamaConfig.tiny(n_experts=4, moe_top_k=2)
    params = M.random_quantized_params(cfg, 7, lm_head_bits=8, device="cpu")
    want = M.requantize_params(params, bits, group_size=gs)
    got = M.requantize_params(_to(params, dev), bits, group_size=gs)
    leaves = [(got["lm_head"], want["lm_head"])] + [
        (gl[k], wl[k]) for gl, wl in zip(got["layers"], want["layers"])
        for k in gl if dataclasses.is_dataclass(gl[k])]
    assert len(leaves) == 1 + 2 * 7
    for a, b in leaves:
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, torch.Tensor):
                assert x.device.type == "cuda"
                assert torch.equal(x.cpu().view(torch.uint8)
                                   if x.dtype == torch.bfloat16 else x.cpu(),
                                   y.view(torch.uint8)
                                   if y.dtype == torch.bfloat16 else y), f.name
            else:
                assert x == y, f.name


def test_rejection_sampling_marginal_on_card(dev):
    """The reference's Monte-Carlo check of rejection_sample_step with a
    CUDA generator: the first emitted token is distributed as p."""
    from piquant_tpu_torch.models import speculative as SP

    import numpy as np

    v, g, n = 8, 2, 4096
    gen = _gen(dev, 7)
    rng = np.random.default_rng(0xACC)
    p_row = torch.from_numpy(rng.dirichlet(np.ones(v)).astype(np.float32)
                             ).to(dev)
    q_row = torch.from_numpy(rng.dirichlet(np.ones(v) * 0.3).astype(
        np.float32)).to(dev)
    p = p_row.expand(n, g + 1, v)
    q = q_row.expand(n, g, v)
    drafts = torch.multinomial(q.reshape(-1, v), 1, generator=gen).reshape(
        n, g).to(torch.int32)
    n_acc, next_tok = SP.rejection_sample_step(p, q, drafts, gen)
    first = torch.where(n_acc >= 1, drafts[:, 0], next_tok).long()
    emp = torch.bincount(first, minlength=v).double() / n
    tv = 0.5 * float((emp - p_row.double()).abs().sum())
    acc = float((n_acc >= 1).double().mean())
    assert tv < 0.04, tv
    assert 0.05 < acc < 1.0, acc


# GQA reps above 8: the decode kernels take a group of 8 rep heads a block
# (a group index in the grid, a ticket and a merge of its own), flash a
# 128-row item of rep heads x 128 // rep positions (rep 16: 8 positions,
# rep 64: 2).  Reps 9 (a group of 1 beside one of 8), 12 (Mistral-Large-2),
# 16 (Qwen3-235B-A22B, Llama-3.1-405B) and 64 (a multi-query layer of 64
# heads); kv8 and kv4 with rows of one split and of several (merged), a
# row with no live position and window starts; bounds as at reps 1-8.
GQA_REPS = [9, 12, 16, 64]


@pytest.mark.parametrize("rep", GQA_REPS)
@pytest.mark.parametrize("kv", ["kv8", "kv4"])
@pytest.mark.parametrize("d", [128, 256])
def test_decode_attn2_reps_above_8(dev, rep, kv, d):
    g = _gen(dev, 9000 + rep + d + (kv == "kv4"))
    nl, b, hkv, s = 2, 4, 2, 2048
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
    pos = torch.tensor([0, 33, 2047, 1501], dtype=torch.int32, device=dev)
    start = torch.tensor([0, 0, 1025, 3], dtype=torch.int32, device=dev)
    before = kern.launches
    acc, m, l = kern(q, kc, ks, vc, vs, pos, start, d ** -0.5, 1)
    assert kern.launches == before + 1
    pacc, pm, pl = DA.decode_attn2_plain(q, kc, ks, vc, vs, pos, start,
                                         d ** -0.5, 1)
    assert (m[0] == -1e30).all() and (l[0] == 0).all() and (acc[0] == 0).all()
    torch.testing.assert_close(m, pm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, pl, rtol=2e-2, atol=0)
    torch.testing.assert_close(acc[1:] / l[1:], pacc[1:] / pl[1:],
                               atol=2e-3, rtol=2e-2)
    # every group's ticket is back at zero, and a second call is bit-equal
    torch.cuda.synchronize()
    assert int(_build.tickets(dev, b * hkv * -(-rep // 8)).abs().sum()) == 0
    again = kern(q, kc, ks, vc, vs, pos, start, d ** -0.5, 1)
    assert all(torch.equal(x, y) for x, y in zip(again, (acc, m, l)))


@pytest.mark.parametrize("rep", GQA_REPS)
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("peaked", [False, True])
def test_decode_attn_reps_above_8(dev, rep, d, peaked):
    g = _gen(dev, 9100 + rep + d + peaked)
    b, hkv, s = 3, 2, 2048
    kc, ks, vc, vs = _v1_cache(dev, g, b, hkv, s, d, peaked)
    q = torch.randn((b, hkv, rep, d), generator=g, device=dev).to(
        torch.bfloat16)
    pos = torch.tensor([0, s - 1, 700], dtype=torch.int32, device=dev)
    before = AT.decode_attn.launches
    got = AT.decode_attn(q, kc, ks, vc, vs, pos, d ** -0.5)
    assert AT.decode_attn.launches == before + 1
    want = AT.decode_attn_plain(q, kc, ks, vc, vs, pos, d ** -0.5)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-2)


# flash at each rep: causal at T of whole 128-row tiles and ragged (T 1
# and a T of fewer positions than an item holds), a window, Llama-4's
# chunk with pos0, GPT-OSS's sinks, and the softcap; D 128 and 256.  The
# causal and window cases within the stated bound 2e-3 + 2e-2 |want|, but
# for at most one element in 2^22, and that one within twice the
# probabilities' rounding (`rounding_bound`); the chunk, sinks and softcap
# within the stated bound plus that, as test_flash_chunk_sinks_match_plain.
# The gap's tail grows with the elements, not the rep: over 16 seeds on the
# card (tools/flash_rep_tail.py), rep 8 at B 16 and D 128 (8.4M elements)
# put one element past the stated bound, rep 64 at B 2 and D 256 (16.8M)
# one, every case within a third of the wider bound.
FLASH_ROUNDING_MODES = ("chunk", "sinks", "softcap")
FLASH_REP_MODES = {
    "causal": {}, "window": dict(window=63), "window_wide": dict(window=200),
    "chunk": dict(chunk=96, pos0=(40, 1000)), "sinks": dict(sinks=True),
    "softcap": dict(softcap=2.0)}


@pytest.mark.parametrize("rep", GQA_REPS)
@pytest.mark.parametrize("mode", list(FLASH_REP_MODES))
@pytest.mark.parametrize("t", [256, 200, 5, 1])
@pytest.mark.parametrize("d", [128, 256])
def test_flash_reps_above_8(dev, rep, mode, t, d):
    g = _gen(dev, 9200 + rep * t + d + len(mode))
    b, hkv = 2, 2
    kw = dict(FLASH_REP_MODES[mode])
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
    assert bool(torch.isfinite(got).all())
    gap, stated = (got - want).abs(), 2e-3 + 2e-2 * want.abs()
    wide = stated + 2 * FL.rounding_bound(q, k, v, sm, **kw)
    assert bool((gap <= wide).all())
    if mode not in FLASH_ROUNDING_MODES:
        assert int((gap > stated).sum()) <= got.numel() // 2 ** 22


# A rep above 128 cannot share a 128-row flash item: its heads go in groups
# of 128, one position an item (rep 160: a group of 128 and one of 32); the
# decode kernels take its 20 groups of 8.
@pytest.mark.parametrize("t", [130, 7])
def test_flash_rep_above_128(dev, t):
    g = _gen(dev, 9300 + t)
    b, hkv, rep, d = 1, 2, 160, 128
    q = torch.randn((b, hkv, rep, t, d), generator=g, device=dev)
    k = torch.randn((b, hkv, t, d), generator=g, device=dev)
    v = torch.randn((b, hkv, t, d), generator=g, device=dev)
    sinks = torch.randn((hkv, rep), generator=g, device=dev)
    got = FL.flash_attn(q, k, v, d ** -0.5, sinks=sinks)
    want = FL.flash_attn_plain(q, k, v, d ** -0.5, sinks=sinks)
    lim = 2e-3 + 2e-2 * want.abs() + 2 * FL.rounding_bound(
        q, k, v, d ** -0.5, sinks=sinks)
    assert bool(((got - want).abs() <= lim).all())


def test_decode_attn2_rep_160(dev):
    g = _gen(dev, 9400)
    nl, b, hkv, s, d = 1, 2, 1, 1024, 128
    shape = (nl, b, hkv, s, d)
    kc, vc = (torch.randint(-127, 128, shape, generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(shape[:-1] + (1,), generator=g, device=dev) * 0.02
              for _ in range(2))
    q = torch.randn((b, hkv, 160, d), generator=g, device=dev)
    pos = torch.tensor([1000, 17], dtype=torch.int32, device=dev)
    start = torch.zeros(2, dtype=torch.int32, device=dev)
    acc, m, l = DA.decode_attn2(q, kc, ks, vc, vs, pos, start, d ** -0.5, 0)
    pacc, pm, pl = DA.decode_attn2_plain(q, kc, ks, vc, vs, pos, start,
                                         d ** -0.5, 0)
    torch.testing.assert_close(m, pm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(acc / l, pacc / pl, atol=2e-3, rtol=2e-2)


def test_safetensors_shards_to_card(dev, tmp_path):
    """A checkpoint written in shards and read back straight to the card:
    every tensor (bf16, f32, int8, bool) bit for bit on the device, by the
    index's weight_map; the weight cache and the safetensors export of a
    quantized tree come back on the card leaf for leaf."""
    from piquant_tpu_torch.utils import safetensors_io as ST
    from piquant_tpu_torch.utils import weight_cache as WC
    from piquant_tpu_torch.quant.linear import quantize_linear_weight

    g = _gen(dev, 20)
    sd = {"a.bf16": torch.randn(300, 257, generator=g,
                                device=dev).bfloat16(),
          "b.f32": torch.randn(1000, generator=g, device=dev),
          "c.i8": torch.randint(-128, 128, (7, 9), generator=g, device=dev,
                                dtype=torch.int8),
          "d.bool": torch.rand(33, generator=g, device=dev) > 0.5}
    ST.save_checkpoint(sd, str(tmp_path / "ckpt"), shards=3)
    back = ST.load_checkpoint(str(tmp_path / "ckpt"), dev)
    for k, t in sd.items():
        assert back[k].device == t.device and back[k].dtype == t.dtype
        assert torch.equal(back[k], t), k
    tree = {"w": quantize_linear_weight(
        torch.randn(512, 256, generator=g, device=dev), 4, group_size=32),
        "e": sd["a.bf16"], "n": [sd["b.f32"]]}
    WC.save_quantized(str(tmp_path / "cache"), tree)
    ST.save_safetensors(str(tmp_path / "x.safetensors"), tree)
    for got in (WC.load_quantized(str(tmp_path / "cache"), device=dev),
                ST.load_safetensors(str(tmp_path / "x.safetensors"),
                                    device=dev)):
        assert torch.equal(got["e"], tree["e"])
        assert torch.equal(got["n"][0], tree["n"][0])
        for f in ("data", "scale", "zero_point", "s_chunk", "z_chunk"):
            assert torch.equal(getattr(got["w"], f), getattr(tree["w"], f))
            assert getattr(got["w"], f).device.type == "cuda"
