"""The port's mesh and quantized ring collectives (piquant_tpu_torch.
parallel: mesh.py, collectives.py) against the JAX package's, on the same
numpy addends: once over an 8-process gloo world (one process a rank) and
once stacked in this process (8 CPU ranks), against JAX's shard_map
results on the 8-device CPU mesh.  Nearest rounding is deterministic, so
each hop's wire bytes equal the reference's `_quantize_chunk` and the
outputs agree within rtol 3e-7 / atol 2e-6 (the reference's tolerance for
XLA's mul+add contraction on the CPU); stochastic rounding draws other
bits, so it is held by the reference test's bias statistic."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from piquant_tpu.parallel import collectives as JC
from piquant_tpu.parallel import make_mesh as j_make_mesh
from piquant_tpu.dtypes import dtype_of as j_dtype_of
from piquant_tpu_torch.parallel import collectives as C
from piquant_tpu_torch.parallel import make_mesh, quantized_psum
from tests import torch_dist_worker as W
from _torch_threads import one_thread  # noqa: F401

SEED = 0x9032002
TOL = dict(rtol=3e-7, atol=2e-6)


def _addends(p, n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (p, n)).astype(np.float32)


INPUTS = dict(rs=_addends(8, 1024, SEED), ag=_addends(8, 256, SEED + 1),
              ar=_addends(8, 1000, SEED + 2),
              stoch=_addends(8, 8192, SEED + 3),
              psum=_addends(8, 512, SEED + 4),
              psum_tp=_addends(4, 512, SEED + 5))


def _smap(fn, mesh, specs=(P("x"),), out=P("x")):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=specs, out_specs=out,
                                 check_vma=False))


@pytest.fixture(scope="module")
def want():
    """The JAX package's results on the 8-device CPU mesh, once."""
    mesh = j_make_mesh([("x", -1)])
    grid = j_make_mesh([("dp", 2), ("tp", -1)])
    a = {k: jnp.asarray(v) for k, v in INPUTS.items()}
    w = {"rs": _smap(lambda x: JC.quantized_reduce_scatter(
        x[0], "x", "uint8", "nearest")[None], mesh)(a["rs"]),
        "ag": _smap(lambda x: JC.quantized_all_gather(
            x[0], "x", "uint8", "nearest")[None], mesh)(a["ag"]),
        # jitted: an eager shard_map runs op by op over 8 devices (~30 s)
        "psum": jax.jit(lambda v: JC.quantized_psum(
            v, mesh, "x", "uint8", "nearest"))(a["psum"]),
        "psum_tp": jax.jit(lambda v: JC.quantized_psum(
            v, grid, "tp", "uint8", "nearest"))(a["psum_tp"])}
    for q in ("uint8", "uint4"):
        w[f"ar_{q}"] = _smap(lambda x: JC.quantized_all_reduce(
            x[0], "x", q, "nearest")[None], mesh)(a["ar"])
    return {k: np.asarray(v, np.float32) for k, v in w.items()}


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """The port over an 8-process gloo world, spawned once."""
    return W.spawn(W.collectives, tmp_path_factory.mktemp("gloo"), INPUTS)


@pytest.fixture(scope="module")
def stacked():
    """The port stacked in this process: 8 CPU ranks."""
    mesh = make_mesh([("x", 8)], devices=["cpu"] * 8)
    x = mesh.axis("x")
    t = {k: torch.from_numpy(v) for k, v in INPUTS.items()}
    got = {"rs": C.quantized_reduce_scatter(t["rs"], x, "uint8", "nearest"),
           "ag": C.quantized_all_gather(t["ag"], x, "uint8", "nearest"),
           "stoch": C.quantized_all_reduce(
               t["stoch"], x, "uint8", "stochastic",
               generator=torch.Generator().manual_seed(0)),
           "psum": quantized_psum(t["psum"], mesh, "x", "uint8", "nearest")}
    for q in ("uint8", "uint4"):
        got[f"ar_{q}"] = C.quantized_all_reduce(t["ar"], x, q, "nearest")
    grid = make_mesh([("dp", 2), ("tp", -1)], devices=["cpu"] * 8)
    got["psum_tp"] = quantized_psum(t["psum_tp"], grid, "tp", "uint8",
                                    "nearest")
    return {k: v.numpy() for k, v in got.items()}


def _per_rank(got, name):
    """Rank-major results: the gloo ranks' list, or a stacked array."""
    if isinstance(got, list):
        return np.stack([r[name] for r in got])
    return got[name]


FORMS = ["gloo", "stacked"]


def test_make_mesh_shapes_and_errors():
    m = make_mesh([("dp", 2), ("tp", -1)], devices=["cpu"] * 8)
    assert m.shape == {"dp": 2, "tp": 4} and m.axis_names == ("dp", "tp")
    assert m.ranks.tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    ax = m.axis("tp")
    assert ax.size == 4 and ax.devices == (torch.device("cpu"),)
    assert make_mesh([("x", -1)], devices=["cpu"] * 3).shape == {"x": 3}
    for axes, msg in (([("a", -1), ("b", -1)], "at most one"),
                      ([("a", 3), ("b", -1)], "not divisible"),
                      ([("a", 2), ("b", 2)], "wants 4 devices")):
        with pytest.raises(ValueError, match=msg):
            make_mesh(axes, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="no axis"):
        m.axis("pp")
    with pytest.raises(ValueError, match="stacked over"):
        C.quantized_all_reduce(torch.zeros(3, 8), ax, "uint8", "nearest")
    with pytest.raises(ValueError, match="byte wire format"):
        C.quantized_all_reduce(torch.zeros(4, 8), ax, "uint16", "nearest")
    with pytest.raises(ValueError, match="not divisible"):
        C.quantized_reduce_scatter(torch.zeros(4, 6), ax, "uint8", "nearest")
    with pytest.raises(ValueError, match="generator"):
        C.quantized_all_reduce(torch.zeros(4, 8), ax, "uint8", "stochastic")


def test_gloo_mesh_groups(gloo):
    """A 2 x 4 mesh over 8 processes: each rank's dp and tp groups are its
    column and its row of the rank array."""
    for r, res in enumerate(gloo):
        assert res["shape"] == ({"x": 8}, {"dp": 2, "tp": 4})
        assert res["groups"] == {"dp": [r % 4, r % 4 + 4],
                                 "tp": list(range(r // 4 * 4, r // 4 * 4 + 4))}
        assert res["coords"] == {"dp": r // 4, "tp": r % 4}


@pytest.mark.parametrize("form", FORMS)
def test_reduce_scatter_shards(form, gloo, stacked, want):
    got = _per_rank(gloo if form == "gloo" else stacked, "rs")
    np.testing.assert_allclose(got, want["rs"].reshape(got.shape), **TOL)


def test_hop_wires_equal_reference(gloo):
    """Every hop's fused wire buffer, [codes | scale | zp], equals the JAX
    package's `_quantize_chunk` of the same chunk byte for byte."""
    dt = j_dtype_of("uint8")
    n = 0
    for res in gloo:
        for chunk, wire in res["rs_wires"]:
            ref = np.asarray(JC._quantize_chunk(jnp.asarray(chunk), dt,
                                                "nearest", None))
            np.testing.assert_array_equal(wire, ref)
            n += 1
    assert n == 8 * 7


@pytest.mark.parametrize("form", FORMS)
def test_all_gather_orders_shards(form, gloo, stacked, want):
    got = _per_rank(gloo if form == "gloo" else stacked, "ag")
    for d in range(1, 8):
        np.testing.assert_array_equal(got[0], got[d])
    np.testing.assert_allclose(got, want["ag"], **TOL)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("qdtype", ["uint8", "uint4"])
def test_all_reduce_matches_reference(form, qdtype, gloo, stacked, want):
    got = _per_rank(gloo if form == "gloo" else stacked, f"ar_{qdtype}")
    for d in range(1, 8):
        np.testing.assert_array_equal(got[0], got[d])
    np.testing.assert_allclose(got, want[f"ar_{qdtype}"], **TOL)


@pytest.mark.parametrize("form", FORMS)
def test_psum_matches_reference(form, gloo, stacked, want):
    res = gloo if form == "gloo" else [stacked]
    for r in res:
        np.testing.assert_allclose(r["psum"], want["psum"], **TOL)
        np.testing.assert_allclose(r["psum_tp"], want["psum_tp"], **TOL)
    assert np.abs(res[0]["psum"] - INPUTS["psum"].sum(0)).max() < 0.6


@pytest.mark.parametrize("form", FORMS)
def test_stochastic_all_reduce_unbiased(form, gloo, stacked):
    """The reference test's statistic (tests/test_collectives.py): the
    mean error over 8192 sums is ~0, and every rank fed the same seed
    holds the same replica."""
    got = _per_rank(gloo if form == "gloo" else stacked, "stoch")
    for d in range(1, 8):
        np.testing.assert_array_equal(got[0], got[d])
    assert abs(float(np.mean(got[0] - INPUTS["stoch"].sum(0)))) < 0.02


def test_one_send_per_hop(gloo, monkeypatch):
    """The codes and both scalars ride ONE buffer, so the reduce-scatter
    and the all-gather each send P-1 times a rank (gloo: isend ops; stacked:
    rolls of the wire rows)."""
    for res in gloo:
        assert res["rs_sends"] == 7 and res["ag_sends"] == 7
    hops = []
    real = C._send_recv
    monkeypatch.setattr(C, "_send_recv",
                        lambda w, axis: hops.append(w.shape) or real(w, axis))
    x = make_mesh([("x", 8)], devices=["cpu"] * 8).axis("x")
    C.quantized_reduce_scatter(torch.zeros(8, 64 * 8), x, "uint8", "nearest")
    C.quantized_all_gather(torch.zeros(8, 64), x, "uint8", "nearest")
    assert len(hops) == 2 * 7 and all(s[0] == 8 for s in hops)
