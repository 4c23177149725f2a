"""The port's fused int8 ring all-reduce (piquant_tpu_torch.parallel.
rdma_ring, the compute in ops/cuda/ring.py) against the JAX package's
Pallas ring in interpret mode on the 8-device CPU mesh and against the
reference tests' numpy model of its schedule (`_simulate`).

The port's hops neither contract the dequant-ADD into an FMA nor divide by
a reciprocal, so `ring_plain` and the stacked and gloo forms equal
`_simulate` bit for bit; against JAX, whose interpret mode contracts mul +
add, they agree within the reference's rtol 3e-7 / atol 2e-6."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from piquant_tpu.parallel import make_mesh as j_make_mesh
from piquant_tpu.parallel.rdma_ring import (
    rdma_all_reduce_shard as j_shard,
    rdma_quantized_all_reduce as j_all_reduce)
from piquant_tpu_torch.ops.cuda import ring as R
from piquant_tpu_torch.parallel import (make_mesh, rdma_all_reduce_shard,
                                        rdma_quantized_all_reduce,
                                        rdma_ring_selftest)
from tests import torch_dist_worker as W
from tests.test_rdma_ring import _simulate
from _torch_threads import one_thread  # noqa: F401

SEED = 0x5150
TOL = dict(rtol=3e-7, atol=2e-6)


def _addends(p, shape, seed=SEED):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (p,) + shape).astype(np.float32)


INPUTS = {"s4096": _addends(8, (4096,)), "s1000": _addends(8, (1000,)),
          "s16x257": _addends(8, (16, 257)),
          "sim": _addends(8, (8 * 1024,), SEED + 2),
          "bucketed": _addends(8, (3 * 8 * 1024 + 7,), SEED + 3)}


def _bound(x):
    p = x.shape[0]
    return (p - 1) * float(np.abs(x).max()) * p / 254.0


@pytest.fixture(scope="module")
def want():
    """The JAX ring in interpret mode, once per input."""
    mesh = j_make_mesh([("x", -1)])
    w = {k: np.asarray(j_all_reduce(jnp.asarray(INPUTS[k]), mesh, "x",
                                    interpret=True))
         for k in ("s4096", "s1000", "s16x257", "sim")}
    w["bucketed"] = np.asarray(jax.jit(jax.shard_map(
        lambda xs: j_shard(xs[0], "x", max_chunk_elems=1024,
                           interpret=True)[None],
        mesh=mesh, in_specs=(P("x"),), out_specs=P("x"), check_vma=False,
    ))(jnp.asarray(INPUTS["bucketed"])))[0]
    return w


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    return W.spawn(W.ring, tmp_path_factory.mktemp("ring"), INPUTS)


@pytest.fixture(scope="module")
def stacked():
    mesh = make_mesh([("x", 8)], devices=["cpu"] * 8)
    t = {k: torch.from_numpy(v) for k, v in INPUTS.items()}
    got = {k: rdma_all_reduce_shard(t[k], mesh.axis("x")).numpy()
           for k in ("s4096", "s1000", "s16x257", "sim")}
    got["bucketed"] = rdma_all_reduce_shard(
        t["bucketed"], mesh.axis("x"), max_chunk_elems=1024).numpy()
    return got


@pytest.mark.parametrize("p", [2, 4, 8])
def test_ring_plain_equals_simulation(p):
    x = _addends(p, (p * 1024,), SEED + p)
    want = _simulate(x)
    got = R.ring_plain(torch.from_numpy(x)).numpy()
    for d in range(p):
        np.testing.assert_array_equal(got[d], want)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_stacked_hops_equal_ring_plain(p):
    """The per-hop plain pieces the wrappers run on the CPU, stacked over
    p ranks with a ragged bucket (max_chunk_elems 1024), equal the whole
    ring's plain version bit for bit."""
    x = torch.from_numpy(_addends(p, (3 * p * 1024 + 5,), SEED + 10 + p))
    got = rdma_all_reduce_shard(
        x, make_mesh([("x", p)], devices=["cpu"] * p).axis("x"),
        max_chunk_elems=1024)
    assert torch.equal(got, R.ring_plain(x, 1024))


@pytest.mark.parametrize("form", ["gloo", "stacked"])
def test_schedule_matches_simulation(form, gloo, stacked):
    x = INPUTS["sim"]
    rows = (np.stack([r["sim"] for r in gloo]) if form == "gloo"
            else stacked["sim"])
    for row in rows:
        np.testing.assert_array_equal(row, _simulate(x))


@pytest.mark.parametrize("form", ["gloo", "stacked"])
@pytest.mark.parametrize("name", ["s4096", "s1000", "s16x257", "sim",
                                  "bucketed"])
def test_matches_jax_ring(form, name, gloo, stacked, want):
    """Against the Pallas ring in interpret mode, and within the int8
    multi-hop bound of the exact sum; every rank's replica identical."""
    x = INPUTS[name]
    if form == "gloo":
        rows = np.stack([r[name] for r in gloo])
    else:
        rows = stacked[name]
    for row in rows:
        np.testing.assert_array_equal(row, rows[0])
    assert rows[0].shape == want[name].shape == x.shape[1:]
    np.testing.assert_allclose(rows[0], want[name], **TOL)
    assert float(np.abs(rows[0] - x.sum(0)).max()) <= _bound(x)


def test_one_send_per_hop(gloo):
    """Codes and scales ride one wire row: P-1 reduce-scatter hops and P-1
    forwarding hops, one send each."""
    for res in gloo:
        for name in ("s4096", "s1000", "s16x257", "sim"):
            assert res[name + "_sends"] == 2 * 7


def test_segments_follow_reference_buckets():
    segs, nbytes = R.segments(3 * 8 * 1024 + 7, 8, 1024)
    assert [(s.x_off, s.nb, s.csize, s.valid) for s in segs] == [
        (0, 3, 1024, 8192), (3 * 8192, 1, 1024, 7)]
    assert nbytes == 3 * (1024 + 4) + (1024 + 4)
    segs, _ = R.segments(1000, 8, 65536)
    assert [(s.nb, s.csize, s.valid) for s in segs] == [(1, 1024, 1000)]


def test_bad_chunk_quantum_raises():
    mesh = make_mesh([("x", 8)], devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="multiple"):
        rdma_all_reduce_shard(torch.zeros(8, 64), mesh.axis("x"),
                              max_chunk_elems=1000)
    with pytest.raises(ValueError, match="stacked over the mesh axis"):
        rdma_quantized_all_reduce(torch.zeros(4, 64), mesh, "x")


def test_padding_only_chunks_give_zeros():
    """(1000,) at P = 8 pads to 8 chunks of 1024: the last chunks hold
    padding only, take the 1e-30 scale floor and give zero codes, not NaN;
    the output keeps f32 and x's shape."""
    x = torch.from_numpy(_addends(8, (1000,), SEED + 7)).to(torch.bfloat16)
    got = rdma_quantized_all_reduce(
        x, make_mesh([("x", 8)], devices=["cpu"] * 8), "x")
    assert got.dtype == torch.float32 and got.shape == (1000,)
    assert torch.isfinite(got).all()


def test_loopback_selftest_cpu():
    assert 0.0 <= rdma_ring_selftest(rows=64, device="cpu") < 0.1


# ring_hop's plan: every csize that is a multiple of QUANTUM up to twice the
# on-chip capacity, and the csizes of the reference tests' shapes (and the
# selftest's 32768 and Llama-3-8B's w1 at P = 8).
PLAN_CSIZES = sorted(set(range(R.QUANTUM, 2 * R.ONCHIP_MAX + 1, R.QUANTUM))
                     | {s.csize for shape, chunk in (
                         ((4096,), 65536), ((1000,), 65536),
                         ((16 * 257,), 65536), ((3 * 8 * 1024 + 7,), 1024),
                         ((4096 * 14336,), 65536))
                        for p in (2, 4, 8)
                        for s in R.segments(int(np.prod(shape)), p, chunk)[0]}
                     | {32768, 4, 1020, 2 * R.ONCHIP_MAX + 4})


def test_hop_plan_covers_each_group_once():
    """hop_plan's launch, in the kernels' group order (`hop_groups`), takes
    every group of 4 values of a chunk exactly once; the chunk stays on chip
    up to ONCHIP_MAX values and takes the two-pass path only past it."""
    for csize in PLAN_CSIZES:
        plan = R.hop_plan(csize)
        assert plan.cluster in R.CLUSTERS, csize
        if csize <= R.ONCHIP_MAX:
            assert plan.vals in R.HOP_VALS, csize
            assert plan.cluster * R.HOP_THREADS * plan.vals >= csize, csize
        else:
            assert plan.vals == 0, csize
        g = R.hop_groups(plan, csize)
        live = g[g >= 0]
        assert torch.equal(live.sort().values,
                           torch.arange(csize // 4)), csize


def test_hop_plan_picks():
    """Llama-3-8B's w1 chunk (65,536 values) on a cluster of PREF_CLUSTER
    blocks of 32 values a thread; small chunks on one block; a chunk just
    past the capacity on the two-pass path."""
    assert R.hop_plan(65536) == R.HopPlan(32, R.PREF_CLUSTER)
    assert R.hop_plan(1024) == R.HopPlan(4, 1)
    assert R.hop_plan(R.ONCHIP_MAX) == R.HopPlan(32, 8)
    assert R.hop_plan(R.ONCHIP_MAX + 1024).vals == 0


def test_ring_gpu_cases_reach_each_path():
    """The GPU tests' shapes (tests/test_torch_cuda.py) reach both hop
    paths and a second segment whose wire offset is 4-byte but not 16-byte
    aligned."""
    segs, _ = R.segments(2 * 262144 + 300007, 2, 262144)
    assert [R.hop_plan(s.csize).vals == 0 for s in segs] == [True, True]
    segs, _ = R.segments(2 * 262144 + 5000, 2, 262144)
    assert [R.hop_plan(s.csize).vals == 0 for s in segs] == [True, False]
    segs, _ = R.segments(14336, 4, 1024)
    assert segs[1].w_off % 4 == 0 and segs[1].w_off % 16
