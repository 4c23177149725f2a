"""The port's CUDA kernels against their plain PyTorch versions, on the GPU,
at shapes beyond the main path (several row tiles, every GQA rep the
kernels take, ragged T) and for the inputs the kernels refuse.

These tests need a CUDA card and skip elsewhere.  On a GPU machine without
JAX (this file imports none of it), run them without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from piquant_tpu_torch.ops.cuda import decode_attn2 as DA
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
    # an INT8 weight at decode M reaches the reference's _w8_kernel, which
    # is not ported: no quiet dequant path on the card
    w8 = QuantizedLinear(data=torch.zeros((256, 128), dtype=torch.uint8,
                                          device=dev),
                         scale=f[None], zero_point=z[None], bits=8, k=256)
    with pytest.raises(NotImplementedError):
        Q.quantized_matmul(x[:8], w8)


# Normalized context element by element within atol 2e-3, rtol 2e-2; m to
# f32 rounding; l within 2e-2 (bf16 probabilities at different running
# maxima in the two).
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
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


def test_decode_attn2_refuses(dev):
    q = torch.zeros((1, 1, 3, 128), device=dev)
    kc = torch.zeros((1, 1, 1, 256, 128), dtype=torch.int8, device=dev)
    ks = torch.zeros((1, 1, 1, 256, 1), device=dev)
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError):          # rep 3
        DA.decode_attn2(q, kc, ks, kc, ks, pos, pos, 1.0, 0)
    with pytest.raises(NotImplementedError):          # head_dim 256
        DA.decode_attn2(torch.zeros((1, 1, 2, 256), device=dev),
                        torch.zeros((1, 1, 1, 256, 256), dtype=torch.int8,
                                    device=dev), ks, kc, ks, pos, pos, 1.0, 0)


# Output element by element within atol 2e-3, rtol 2e-2 (bf16
# probabilities before PV in both; another tile order for the online
# softmax).
@pytest.mark.parametrize("rep,t", [(1, 256), (2, 384), (4, 200), (8, 128)])
def test_flash_matches_plain(dev, rep, t):
    g = _gen(dev, rep * t)
    b, hkv, d = 2, 2, 128
    q = torch.randn((b, hkv, rep, t, d), generator=g, device=dev)
    k = torch.randn((b, hkv, t, d), generator=g, device=dev)
    v = torch.randn((b, hkv, t, d), generator=g, device=dev)
    got = FL.flash_attn(q, k, v, d ** -0.5)
    want = FL.flash_attn_plain(q, k, v, d ** -0.5)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-2)


def test_flash_refuses(dev):
    q = torch.zeros((1, 1, 2, 128, 64), device=dev)
    k = torch.zeros((1, 1, 128, 64), device=dev)
    with pytest.raises(NotImplementedError):          # head_dim 64
        FL.flash_attn(q, k, k, 1.0)
    with pytest.raises(NotImplementedError):          # rep 3
        FL.flash_attn(torch.zeros((1, 1, 3, 128, 128), device=dev),
                      torch.zeros((1, 1, 128, 128), device=dev),
                      torch.zeros((1, 1, 128, 128), device=dev), 1.0)
