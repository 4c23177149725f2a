"""The decode GEMVs' split chooser (piquant_tpu_torch/ops/cuda/qmatmul.py::
gemv_split), a function of the shapes and the card's cluster residency, at
the shapes `chip_smoke.py` drives (Llama-3-8B's projections and INT8
lm_head, the Qwen2-7B, Phi-3-mini and Qwen3-30B-A3B decode layers), and the
channelwise GEMVs' optional row sums (xsum None: computed from x)."""

import numpy as np
import pytest
import torch

from piquant_tpu_torch.ops.cuda import qmatmul as Q

SMS = 132   # an H100 SXM's SMs
# Blocks of clusters of each size an H100 holds at once
# (cudaOccupancyMaxActiveClusters times the size, on an H100 80GB HBM3 by
# `tools/gemv_compare.py . this clusters` for ks 2, 3, 4, 8; 5-7 taken as
# 8's): one block an SM (the light forms, and every form above M 8) and
# two (the per-group forms at M <= 8, ~70-100 KB of shared memory).
RESIDENT = {1: {1: 132, 2: 132, 3: 117, 4: 120, 5: 120, 6: 120, 7: 120,
                8: 120},
            2: {1: 264, 2: 264, 3: 237, 4: 248, 5: 240, 6: 240, 7: 240,
                8: 240}}
# Packed rows a ring stage of each instance by n8 token tiles
# (pq_gemv_attributes' out[5], printed by `tools/gemv_compare.py . this
# clusters` and chip_smoke.py's phase 3): the light forms (channelwise,
# NF4 channelwise) and those with per-group work.
STAGE = {True: {1: 256, 2: 128, 4: 64, 8: 32},
         False: {1: 64, 2: 64, 4: 64, 8: 32}}
LLAMA = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
QWEN2 = ((3584, 3584), (3584, 512), (3584, 18944), (18944, 3584))
PHI3 = ((3072, 3072), (3072, 8192), (8192, 3072))
A3B = ((2048, 4096), (2048, 512), (4096, 2048), (2048, 768), (768, 2048))
LM_HEAD = ((4096, 128256),)


def _resident(m, light=True):
    return RESIDENT[2 if Q.gemv_tiles(m) == 1 and not light else 1].get


def _split(m, k, n, planes, light=True, resident=True):
    return Q.gemv_split(k, n, SMS, planes, STAGE[light][Q.gemv_tiles(m)],
                        _resident(m, light) if resident else None)


def _check_split(m, k, n, planes, light=True):
    ksplit, per = _split(m, k, n, planes, light)
    rows = k // planes
    mt = Q.gemv_tiles(m)
    stage = STAGE[light][mt]
    assert 8 * mt >= m                                 # all rows in one block
    assert 1 <= ksplit <= Q.GEMV_CLUSTER               # the cluster limit
    assert ksplit * per >= rows > (ksplit - 1) * per   # every row once
    assert per % stage == 0 and stage % 32 == 0        # whole stages, units
    tiles = n // 128
    if ksplit > 1:                                     # one wave
        assert tiles * ksplit <= _resident(m, light)(ksplit)
    return ksplit, per


@pytest.mark.parametrize("m", [1, 8, 9, 16, 33, 63, 64])
@pytest.mark.parametrize("planes", [1, 2, 4])
@pytest.mark.parametrize("shapes", [LLAMA, QWEN2, PHI3, A3B, LM_HEAD],
                         ids=["llama3_8b", "qwen2_7b", "phi3_mini",
                              "qwen3_30b_a3b", "lm_head"])
@pytest.mark.parametrize("light", [True, False])
def test_gemv_split_properties(m, planes, shapes, light):
    for k, n in shapes:
        if (k // planes) % 32 == 0:
            _check_split(m, k, n, planes, light)


def test_gemv_split_llama():
    # M 8, light forms (one block an SM, 256-row stages): the largest split
    # whose grid fits, in whole stages a split: wq / wo 3 ways (96 blocks),
    # wk / wv 8 (64: the cluster limit), w1 / w3 none (112 column tiles),
    # w2 3 ways; the INT8 lm_head's 1002 column tiles take no split
    got = [_split(8, k, n, 2) for k, n in LLAMA]
    assert got == [(3, 768), (8, 256), (1, 2048), (3, 2560)]
    assert _split(8, 4096, 128256, 1) == (1, 4096)
    # M 64 (one block an SM): 32-row stages; N 14336 fills the card unsplit,
    # N 4096 splits three ways (clusters of 4 fit only 120 blocks)
    assert _split(64, 4096, 14336, 2) == (1, 2048)
    assert _split(64, 4096, 4096, 2) == (3, 704)
    # the per-group forms at M 8: 64-row stages, two blocks an SM
    assert _split(8, 4096, 4096, 2, False) == (7, 320)
    # no residency given: the SM count bounds the grid
    assert _split(8, 4096, 4096, 2, resident=False) == (4, 512)


def test_gemv_split_groups():
    """A split never cuts a 32-row unit of the chunk form (gs % 32 == 0) or
    an 8-row half of the pre-scaled forms (gs % 8 == 0): splits start on
    stage rows, multiples of 32; where the group divides the split, it
    holds whole groups."""
    for m in (8, 33, 64):
        for k, n in LLAMA:
            for planes, gs in ((2, 128), (4, 32), (2, 256)):
                if (k // planes) % gs:
                    continue
                ksplit, per = _check_split(m, k, n, planes, False)
                starts = np.arange(ksplit) * per
                assert (starts % 32 == 0).all()
                if per % gs == 0:
                    assert (starts % gs == 0).all()


def test_gemv_stage_rows():
    # every stage a whole number of the kernels' 32-row units (a split, made
    # of stages, then never cuts one); the light forms take 256-row stages
    # at M <= 8 and 128 at M <= 16, the rest 64; above M 16 all alike
    for light, rows in STAGE.items():
        assert all(r % 32 == 0 for r in rows.values())
    assert STAGE[True] == {1: 256, 2: 128, 4: 64, 8: 32}
    assert STAGE[False] == {1: 64, 2: 64, 4: 64, 8: 32}
    assert [Q.gemv_tiles(m) for m in (1, 8, 9, 16, 17, 32, 33, 64)] == [
        1, 1, 2, 2, 4, 4, 8, 8]
    assert len(set(Q.GEMV_FORMS)) == 10


def test_gemv_plan_asks_once(monkeypatch):
    """gemv_plan asks the card for an instance's stage rows and cluster
    residency once a (device, form, shape): later calls of a shape are a
    cache hit; its split is gemv_split's with those answers."""
    asked = []

    def attributes(form, mt, gs, ksplit=0, device=None):
        asked.append((form, mt, gs, ksplit, device))
        return (0, 0, 0, 0, RESIDENT[1].get(ksplit, 0) // max(ksplit, 1),
                STAGE[True][mt])

    monkeypatch.setattr(Q, "gemv_attributes", attributes)
    monkeypatch.setattr(Q._build, "sm_count", lambda index: SMS)
    Q.gemv_plan.cache_clear()
    try:
        form = Q.GEMV_FORMS.index("INT4")
        for k, n in LLAMA:
            plan = Q.gemv_plan(0, form, 8, k, n, 1, 2)
            assert plan == (1,) + _split(8, k, n, 2)
            n_asked = len(asked)
            assert Q.gemv_plan(0, form, 8, k, n, 1, 2) == plan
            assert len(asked) == n_asked
        assert {a[4] for a in asked} == {0} and {a[0] for a in asked} == {form}
        # another device is asked anew
        Q.gemv_plan(1, form, 8, 4096, 4096, 1, 2)
        assert asked[-1][4] == 1
    finally:
        Q.gemv_plan.cache_clear()


@pytest.mark.parametrize("bits,name", [(4, "w4_gemv"), (8, "w8_gemv"),
                                       (2, "w2_gemv")])
@pytest.mark.parametrize("m", [1, 8, 33])
def test_channel_gemv_xsum_optional(bits, name, m):
    """xsum None (the dispatch's call, the kernel sums x itself) gives the
    plain version's result with the row sums of x passed, bit for bit."""
    rng = np.random.default_rng(m + bits)
    k, n = 512, 256
    planes = Q.PLANES[bits]
    x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)
                         ).to(torch.bfloat16)
    data = torch.from_numpy(rng.integers(0, 256, (k // planes, n),
                                         dtype=np.uint8))
    scale = torch.from_numpy(rng.uniform(0.01, 0.02, n).astype(np.float32))
    zp = torch.from_numpy(rng.integers(0, 1 << bits, n).astype(np.int32))
    xsum = x.float().sum(1, keepdim=True)
    kern, plain = getattr(Q, name), getattr(Q, name + "_plain")
    for odt in (torch.bfloat16, torch.float32):
        want = plain(x, data, scale, zp, xsum, odt)
        assert torch.equal(plain(x, data, scale, zp, None, odt), want)
        assert torch.equal(kern(x, data, scale, zp, None, odt), want)


def test_dispatch_passes_no_xsum(monkeypatch):
    """quantized_matmul hands the channelwise GEMVs no row sums (on the
    card no cast and sum launch before the kernel); its result is the
    plain version's with them."""
    from piquant_tpu_torch.quant.linear import quantize_linear_weight

    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(0, 0.05, (512, 256)).astype(np.float32))
    ql = quantize_linear_weight(w, 4)
    x = torch.from_numpy(rng.normal(0, 1, (8, 512)).astype(np.float32)
                         ).to(torch.bfloat16)
    seen = []
    real = Q.w4_gemv

    def spy(x2, data, scale, zp, xsum, out_dtype):
        seen.append(xsum)
        return real(x2, data, scale, zp, xsum, out_dtype)

    monkeypatch.setattr(Q, "w4_gemv", spy)
    y = Q.quantized_matmul(x, ql)
    assert seen == [None]
    want = Q.w4_gemv_plain(x, ql.data, ql.scale.reshape(-1),
                           ql.zero_point.reshape(-1),
                           x.float().sum(1, keepdim=True), torch.bfloat16)
    assert torch.equal(y, want)
