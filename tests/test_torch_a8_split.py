"""The int8-activation GEMMs' tile and split chooser (piquant_tpu_torch/
ops/cuda/qmatmul.py::a8_split), a function of the shapes alone, at the
shapes `chip_smoke.py` drives (phase 8's Llama-3-8B projections, phase 9's
and 11's ragged expert GEMMs), and the ragged plain version under the
routing's live_blocks."""

import numpy as np
import pytest
import torch

from piquant_tpu_torch.ops.cuda import qmatmul as Q
from piquant_tpu_torch.ops.cuda import ragged as R
from piquant_tpu_torch.quant import moe as MO

SMS = 132   # an H100 SXM's SMs
# (K, N) of Llama-3-8B's projections (chip_smoke.W4_SHAPES)
LLAMA = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))


def _check_split(m, k, n, planes, prefill_bm=None):
    bm, ksplit, per = Q.a8_split(m, k, n, SMS, planes, prefill_bm)
    rows = k // planes
    assert ksplit >= 1 and ksplit * per >= rows    # the splits cover K
    assert (ksplit - 1) * per < rows               # and none lies past it
    if m <= Q.M_MAX:                               # the mma.sync decode tiles
        assert bm == (16 if m <= 16 else 64)
        assert per % 32 == 0
        return bm, ksplit, per
    stage = 128 // planes                          # four k32 steps a stage
    cols = 32768 // bm
    assert bm == (prefill_bm or Q.a8_prefill_bm(m, k, planes))
    assert bm in (128, 256) and cols * bm == 32768
    assert per % stage == 0                        # whole stages a split
    tiles = -(-n // cols) * -(-m // bm)
    assert -(-m // bm) * bm >= m and -(-n // cols) * cols >= n
    if ksplit > 1:                                 # no more than one wave
        assert tiles * ksplit <= SMS
        assert per // stage >= 4
    return bm, ksplit, per


@pytest.mark.parametrize("m", [8, 33, 1000, 1024])
@pytest.mark.parametrize("planes", [1, 2, 4])
def test_a8_split_llama(m, planes):
    for k, n in LLAMA:
        _check_split(m, k, n, planes)


def test_a8_split_prefill_choices():
    # 128 tokens x 256 columns up to M 128 and at INT2 with K > 8192, else
    # 256 x 128; a wave of tiles at N 4096 needs no split; N 1024's 32
    # tiles split K four ways; the decode tiles keep theirs
    assert [Q.a8_prefill_bm(m, k, p) for m in (65, 128, 129, 1024)
            for k in (4096, 14336) for p in (1, 2, 4)] == (
        [128] * 12 + [256] * 5 + [128] + [256] * 5 + [128])
    assert Q.a8_split(1024, 4096, 4096, SMS, 2) == (256, 1, 2048)
    assert Q.a8_split(1024, 4096, 1024, SMS, 4) == (256, 4, 256)
    assert Q.a8_split(1024, 14336, 4096, SMS, 4) == (128, 1, 3584)
    assert Q.a8_split(256, 4096, 1024, SMS, 2) == (256, 8, 256)
    assert Q.a8_split(100, 4096, 1024, SMS, 2) == (128, 8, 256)
    assert Q.a8_split(1024, 4096, 4096, SMS, 2, 128) == (128, 1, 2048)
    assert Q.a8_split(1024, 4096, 1024, SMS, 2, 128) == (128, 4, 512)
    assert Q.a8_split(1024, 4096, 1024, SMS, 1, 128) == (128, 4, 1024)
    assert Q.a8_split(1024, 14336, 4096, SMS, 4, 128) == (128, 1, 3584)
    assert Q.a8_split(8, 4096, 4096, SMS, 2) == (16, 16, 128)
    assert Q.a8_split(33, 4096, 1024, SMS, 4) == (64, 8, 128)
    for m in (65, 127, 128, 129, 255, 256, 257, 2048):
        for k, n in LLAMA + ((512, 384), (768, 2048)):
            for planes in (1, 2, 4):
                for bm in (128, 256):
                    _check_split(m, k, n, planes, bm)


# (K, N, padded rows) of the ragged expert GEMMs at 1024 tokens:
# Mixtral-8x7B's w1 / w3 and w2 (top 2 of 8), Qwen3-30B-A3B's (top 8 of
# 128).  The ragged form has no K split; at these rows none is wanted.
@pytest.mark.parametrize("k,n,m", [(4096, 14336, 3072), (14336, 4096, 3072),
                                   (2048, 768, 24448), (768, 2048, 24448)])
@pytest.mark.parametrize("planes", [2, 4])
def test_a8_split_ragged_shapes(k, n, m, planes):
    bm, ksplit, per = _check_split(m, k, n, planes, 128)
    assert (bm, ksplit, per) == (R.ROW_BLOCK, 1, k // planes)
    assert n % 128 == 0 and k % 256 == 0       # the kernel's own gates


def test_ragged_a8_plain_live_blocks():
    """With the routing's live_blocks the plain version equals it without
    (the tail blocks hold zero rows), and rows past live_blocks come out
    zero whatever they hold."""
    e, k, n, ntok = 4, 512, 256, 60
    rng = np.random.default_rng(7)
    logits = rng.normal(0, 1, (ntok, e))
    logits[:, 0] -= 50
    logits[:, 1] += 3
    topi = torch.from_numpy(np.argsort(-logits, axis=1)[:, :2]
                            .astype(np.int32))[None]
    probs = torch.from_numpy(rng.uniform(0, 1, (1, ntok, 2))
                             .astype(np.float32))
    r = MO.build_ragged_routing(topi, probs, e, R.ROW_BLOCK)
    tail = int(r.live_blocks) * R.ROW_BLOCK
    assert tail < r.m_pad
    x = torch.from_numpy(rng.normal(0, 1, (ntok, k)).astype(np.float32))
    xq = MO.scatter_tokens(torch.clamp(x * 40, -127, 127).round()
                           .to(torch.int8), r)
    xs = torch.from_numpy(rng.uniform(0.01, 0.02, (xq.shape[0], 1))
                          .astype(np.float32))
    data = torch.from_numpy(rng.integers(0, 256, (e, k // 2, n),
                                         dtype=np.uint8))
    scale = torch.from_numpy(rng.uniform(0.01, 0.02, (e, n))
                             .astype(np.float32))
    zs = scale * torch.from_numpy(rng.integers(0, 16, (e, n))
                                  .astype(np.float32))
    xsum = xq.float().sum(1, keepdim=True)
    args = (xq, xs, data, scale, zs, xsum, r.block_expert, torch.float32)
    full = R.wq_ragged_a8_plain(*args)
    live = R.wq_ragged_a8_plain(*args, r.live_blocks)
    assert torch.equal(full, live)
    assert not live[tail:].any() and live[:tail].any()
    xq[tail:] = 3                                  # padding that is not zero
    xsum = xq.float().sum(1, keepdim=True)
    got = R.wq_ragged_a8(xq, xs, data, scale, zs, xsum, r.block_expert,
                         torch.float32, r.live_blocks)
    assert not got[tail:].any()
    assert torch.equal(got[:tail], full[:tail])
