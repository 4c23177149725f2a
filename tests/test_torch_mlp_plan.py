"""The fused MLP's host planner (piquant_tpu_torch/ops/cuda/qmatmul.py::
mlp_split / mlp_plan), a function of the shapes and the card's answers, at
the MLPs `chip_smoke.py` drives (Llama-3-8B's SwiGLU, Gemma-7B's GeGLU)
and a small one; and the fused MLP's optional row sums of x (xsum None:
computed from x, the dispatch's call)."""

import numpy as np
import pytest
import torch

from piquant_tpu_torch.ops.cuda import qmatmul as Q

SMS = 132   # an H100 SXM's SMs
# Packed rows a ring stage of the fused MLP's instance by n8 token tiles
# (pq_mlp_attributes' out[4]: csrc/qmatmul_mlp.cu's MlpTile R).
STAGE = {1: 128, 2: 64, 4: 32, 8: 32}
# (K, I, N) of the MLPs
MLPS = {"llama3_8b": (4096, 14336, 4096), "gemma_7b": (3072, 24576, 3072),
        "small": (512, 1024, 512)}


def _check_split(k, i_ff, n, stage, blocks):
    ksb, per = Q.mlp_split(k, i_ff, n, stage, blocks)
    rows = i_ff // 2
    assert ksb >= 1 and per % stage == 0                  # whole stages
    assert ksb * per >= rows > (ksb - 1) * per             # every row once
    # the queue's simulated time is the least over every split count (each
    # with its splits as even as whole stages allow)
    stages = -(-rows // stage)
    best = Q.mlp_makespan(k, i_ff, n, stage, blocks, per // stage)
    for splits in range(1, stages + 1):
        p = -(-stages // splits)
        assert Q.mlp_makespan(k, i_ff, n, stage, blocks, p) >= best - 1e-9
    return ksb, per


@pytest.mark.parametrize("mlp", sorted(MLPS))
@pytest.mark.parametrize("mt", [1, 2, 4, 8])
@pytest.mark.parametrize("blocks", [1, 66, 132, 264])
def test_mlp_split_properties(mlp, mt, blocks):
    _check_split(*MLPS[mlp], STAGE[mt], blocks)


def test_mlp_split_shapes():
    # M <= 8 (128-row stages), 132 blocks.  Llama-3-8B: 112 A items of 16
    # stages take 112 blocks, so w2's 7168 rows go in 8 splits of 896 (16
    # tiles of 256 columns: 128 B items, one round) rather than, say, 14
    # of 512 (224 items, a second round two thirds empty); Gemma-7B's
    # 12288 in 16 splits of 768; the small MLP one stage a split
    assert Q.mlp_split(4096, 14336, 4096, 128, SMS) == (8, 896)
    assert Q.mlp_split(3072, 24576, 3072, 128, SMS) == (16, 768)
    assert Q.mlp_split(512, 1024, 512, 128, SMS) == (4, 128)
    # M 64 (32-row stages)
    assert Q.mlp_split(4096, 14336, 4096, 32, SMS) == (8, 896)
    assert Q.mlp_split(3072, 24576, 3072, 32, SMS) == (28, 448)


@pytest.mark.parametrize("mlp", sorted(MLPS))
@pytest.mark.parametrize("rows_b", [128, 384, 896])
def test_mlp_queue(mlp, rows_b):
    """The kernel's queue as the planner models it: every hidden tile once
    in stage A, the two halves a B split reads queued together, then every
    (split, output tile) once, split-major, the splits covering w2's rows
    once; each split fed by the A items whose 128 columns hold its rows."""
    k, i_ff, n = MLPS[mlp]
    ih, ksb = i_ff // 2, -(-(i_ff // 2) // rows_b)
    items = Q.mlp_queue(k, i_ff, n, rows_b)
    a = [it for it in items if it[0] == "A"]
    b = [it for it in items if it[0] == "B"]
    assert items == a + b
    tiles = [it[1] for it in a]
    assert sorted(tiles) == list(range(i_ff // 128))
    assert all(abs(tiles[u] - tiles[u + 1]) == ih // 128
               for u in range(0, len(tiles), 2))
    assert all(it[2:4] == (0, k // 2) for it in a)
    assert [(it[4], it[1]) for it in b] == [
        (q, c) for q in range(ksb) for c in range(-(-n // 256))]
    assert sorted({(it[2], it[3]) for it in b}) == [
        (q * rows_b, min(q * rows_b + rows_b, ih)) for q in range(ksb)]
    for q in range(ksb):
        r0, r1 = q * rows_b, min(q * rows_b + rows_b, ih)
        fed = [it[1] for it in a if it[4] <= q <= it[5]]
        assert sorted(fed) == sorted(
            t for t in range(i_ff // 128)
            if t * 128 % ih < r1 and t * 128 % ih + 128 > r0)


def test_mlp_makespan():
    """The simulated queue: one block runs every item in turn; a grid as
    large as the items runs stage A, then each split's B items, in one
    round each; never under the work spread evenly over the blocks."""
    k, i_ff, n = MLPS["llama3_8b"]
    a, b_stages, tiles = 16 + Q.MLP_EPILOGUE, 7 + Q.MLP_EPILOGUE, 16
    assert Q.mlp_makespan(k, i_ff, n, 128, 1, 7) == pytest.approx(
        112 * a + 8 * tiles * b_stages)
    assert Q.mlp_makespan(k, i_ff, n, 128, 10_000, 7) == pytest.approx(
        a + b_stages)
    for blocks in (66, 132, 264):
        for per in (1, 4, 7, 14, 56):
            work = 112 * a + tiles * (56 + -(-56 // per) * Q.MLP_EPILOGUE)
            assert (Q.mlp_makespan(k, i_ff, n, 128, blocks, per)
                    >= work / blocks - 1e-9)


@pytest.mark.parametrize("mlp", sorted(MLPS))
@pytest.mark.parametrize("m", [1, 8, 33, 64])
def test_mlp_plan_asks_once(monkeypatch, mlp, m):
    """mlp_plan asks the card for the instance's stage rows and resident
    blocks once a (device, shape); its grid is the resident blocks, or the
    work items (I / 128 of stage A, tiles x splits of B) where they are
    fewer; its split is mlp_split's."""
    k, i_ff, n = MLPS[mlp]
    asked = []

    def attributes(mt, device=None):
        asked.append((mt, device))
        return (128, 0, 200_000, 4, STAGE[mt], 1)

    monkeypatch.setattr(Q, "mlp_attributes", attributes)
    monkeypatch.setattr(Q._build, "sm_count", lambda index: SMS)
    Q.mlp_plan.cache_clear()
    try:
        plan = Q.mlp_plan(0, m, k, i_ff, n)
        mt, blocks, ksb, rows_b = plan
        assert mt == Q.gemv_tiles(m) and 8 * mt >= m
        assert (ksb, rows_b) == Q.mlp_split(k, i_ff, n, STAGE[mt], SMS)
        items = i_ff // Q.MLP_HIDDEN + -(-n // Q.MLP_TILE) * ksb
        assert blocks == min(SMS, items)
        assert Q.mlp_plan(0, m, k, i_ff, n) == plan
        assert asked == [(mt, 0)]
    finally:
        Q.mlp_plan.cache_clear()


def _operands(rng, m, k, i_ff, n):
    x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)
                         ).to(torch.bfloat16)
    w13 = torch.from_numpy(rng.integers(0, 256, (k // 2, 2 * i_ff),
                                        dtype=np.uint8))
    w2 = torch.from_numpy(rng.integers(0, 256, (i_ff // 2, n),
                                       dtype=np.uint8))

    def side(cols, s):
        return (torch.from_numpy(rng.uniform(s / 2, 1.5 * s, cols)
                                 .astype(np.float32)),
                torch.from_numpy(rng.integers(0, 16, cols).astype(np.int32)))

    return (x, w13, *side(2 * i_ff, 0.1 / k ** 0.5), w2,
            *side(n, 0.1 / i_ff ** 0.5))


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("m", [1, 8, 33])
def test_mlp_fused_xsum_optional(act, m):
    """xsum None gives the plain version's result with the row sums of x
    passed, bit for bit; the wrapper on CPU tensors is the plain version."""
    rng = np.random.default_rng(m)
    ops = _operands(rng, m, 512, 1024, 256)
    xsum = ops[0].float().sum(1, keepdim=True)
    for odt in (torch.bfloat16, torch.float32):
        want = Q.mlp_fused_plain(*ops, xsum, act, odt)
        assert torch.equal(Q.mlp_fused_plain(*ops, None, act, odt), want)
        assert torch.equal(Q.mlp_fused(*ops, None, act, odt), want)


def test_mlp_dispatch_passes_no_xsum(monkeypatch):
    """mlp_fused_matmul hands the fused MLP no row sums (on the card one
    launch a call, no cast and sum before it); its result is the plain
    version's with them."""
    from piquant_tpu_torch.quant.linear import quantize_linear_weight

    rng = np.random.default_rng(5)
    w13 = quantize_linear_weight(torch.from_numpy(
        rng.normal(0, 0.05, (512, 2048)).astype(np.float32)), 4)
    w2 = quantize_linear_weight(torch.from_numpy(
        rng.normal(0, 0.05, (1024, 512)).astype(np.float32)), 4)
    x = torch.from_numpy(rng.normal(0, 1, (2, 4, 512)).astype(np.float32)
                         ).to(torch.bfloat16)
    seen = []
    real = Q.mlp_fused

    def spy(*args):
        seen.append(args[7])
        return real(*args)

    monkeypatch.setattr(Q, "mlp_fused", spy)
    monkeypatch.setenv("PIQUANT_MLP_FUSE", "1")
    y = Q.mlp_fused_matmul(x, w13, w2, "silu")
    assert seen == [None]
    x2 = x.reshape(8, 512)
    want = Q.mlp_fused_plain(
        x2, w13.data, w13.scale.reshape(-1), w13.zero_point.reshape(-1),
        w2.data, w2.scale.reshape(-1), w2.zero_point.reshape(-1),
        x2.float().sum(1, keepdim=True), "silu", torch.bfloat16)
    assert torch.equal(y, want.reshape(2, 4, 512))
