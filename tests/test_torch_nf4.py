"""NF4 (NormalFloat-4 codebook) weights and stochastic affine weights of the
port against the JAX package on the CPU: codes and scales byte for byte,
the NF4 GEMV's plain version against the Pallas `_nf4_kernel` in interpret
mode, the matmul routes against `_matmul_nf4_jnp`, the random-weight
constructor, and the tiny dense and MoE models at NF4 against JAX."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from piquant_tpu.models import llama as JM
from piquant_tpu.ops.pallas import qmatmul as JQ
from piquant_tpu.quant import linear as JL
from piquant_tpu_torch import convert
from piquant_tpu_torch.models import llama as TM
from piquant_tpu_torch.ops.cuda import qmatmul as TQ
from piquant_tpu_torch.quant import linear as TL
from test_torch_model import KCFG, _check_logits, _run_jax, _run_port
from _torch_threads import one_thread  # noqa: F401

SEED = 0x4F4
CPU = torch.device("cpu")


def _t(a):
    return convert.tensor_from_numpy(a, CPU)


def _w(k, n, seed, std=0.05):
    return np.random.default_rng(seed).normal(0, std, (k, n)).astype(np.float32)


@pytest.fixture
def counted(monkeypatch):
    """Calls of nf4_gemv's plain version (what the wrapper runs on the CPU)."""
    calls = []
    plain = TQ.nf4_gemv_plain

    def bump(x2, *a, **k):
        calls.append(x2.shape[0])
        return plain(x2, *a, **k)

    monkeypatch.setattr(TQ, "nf4_gemv_plain", bump)
    return calls


def test_codebook_encode_decode_match_jax():
    """The table, the nearest-entry codes (strict > of the f32 midpoints,
    the midpoints themselves included) and the decoded values."""
    assert TL.NF4_CODEBOOK == JL.NF4_CODEBOOK
    lut = np.asarray(JL.NF4_CODEBOOK)
    mids = ((lut[:-1] + lut[1:]) * 0.5).astype(np.float32)
    x = np.concatenate([
        np.random.default_rng(SEED).uniform(-1.1, 1.1, 4000),
        mids, np.nextafter(mids, np.float32(2)), lut]).astype(np.float32)
    got = TL.codebook_encode(_t(x), "nf4")
    want = np.asarray(JL.codebook_encode(jnp.asarray(x), "nf4"))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        TL.codebook_decode(got, "nf4").numpy(),
        np.asarray(JL.codebook_decode(jnp.asarray(want), "nf4")))


@pytest.mark.parametrize("kw", [dict(), dict(channelwise=False),
                                dict(group_size=32), dict(group_size=64),
                                dict(group_size=128)],
                         ids=["channel", "tensor", "g32", "g64", "g128"])
def test_quantize_nf4_byte_equal(kw):
    """Codes and absmax scales byte-equal to `_quantize_nf4`'s, a zero
    column and a zero group included (scale 1)."""
    w = _w(512, 256, SEED + 1)
    w[:, 5] = 0.0
    w[:32, 9] = 0.0
    jq = JL.quantize_linear_weight(jnp.asarray(w), "nf4", **kw)
    tq = TL.quantize_linear_weight(_t(w), "nf4", **kw)
    assert (tq.bits, tq.k, tq.group_size, tq.codebook) == (
        jq.bits, jq.k, jq.group_size, jq.codebook)
    for f in ("data", "scale", "zero_point"):
        np.testing.assert_array_equal(getattr(tq, f).numpy(),
                                      np.asarray(getattr(jq, f)), err_msg=f)
    assert tq.s_chunk is None and tq.z_chunk is None
    np.testing.assert_array_equal(tq.dequantize(torch.float32).numpy(),
                                  np.asarray(jq.dequantize(jnp.float32)))
    with pytest.raises(ValueError):
        tq.to_wire()


# The plain NF4 GEMV against the Pallas kernel in interpret mode: the same
# bf16 table values (and bf16 value x scale for grouped weights), products
# exact in f32 in both, sums in another order: f32 outputs within atol
# 1e-4 + rtol 1e-5, bf16 outputs within one bf16 rounding (rtol 2^-8).
@pytest.mark.parametrize("gs", [None, 64])
@pytest.mark.parametrize("m", [1, 8, 33])
@pytest.mark.parametrize("out_dtype", ["f32", "bf16"])
def test_nf4_gemv_plain_matches_pallas(gs, m, out_dtype, counted):
    k, n = 512, 256
    w = _w(k, n, SEED + 2)
    x = _w(m, k, SEED + 3, std=1.0)
    jq = JL.quantize_linear_weight(jnp.asarray(w), "nf4", group_size=gs)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[out_dtype]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JQ.nf4_matmul(jnp.asarray(x), jq, jdt), np.float32)
    tq = convert.params_from_jax({"w": jq}, device=CPU)["w"]
    got = TQ.nf4_matmul(_t(x), tq, tdt)
    assert counted == [m] and got.dtype == tdt
    tol = (dict(atol=1e-4, rtol=1e-5) if out_dtype == "f32"
           else dict(atol=1e-3, rtol=2 ** -8))
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


# quantized_matmul's routes for NF4 weights, against `_matmul_nf4_jnp` (the
# reference's f32 table product): the GEMV at M <= 64 (bf16 table values,
# 2^-9 relative each: atol 2e-2, rtol 1e-2, the bound of the JAX package's
# own NF4 tests), the same f32 product between 64 and 256 rows (atol 1e-4,
# rtol 1e-5), the dense bf16 product from 256 rows (a bf16 weight: 2e-2 /
# 1e-2); and where the kernel gate declines (N % 128, groups straddling the
# two planes) the f32 product at every M.
@pytest.mark.parametrize("m,k,n,gs,route", [
    (8, 512, 256, None, "gemv"), (8, 512, 256, 64, "gemv"),
    (100, 512, 256, None, "table"), (100, 512, 256, 32, "table"),
    (300, 512, 256, None, "dense"), (300, 512, 256, 64, "dense"),
    (8, 512, 192, None, "table"), (8, 384, 128, 128, "table")])
def test_quantized_matmul_nf4_routes(m, k, n, gs, route, counted):
    w = _w(k, n, SEED + 4)
    x = _w(m, k, SEED + 5, std=1.0)
    jq = JL.quantize_linear_weight(jnp.asarray(w), "nf4", group_size=gs)
    want = np.asarray(JL._matmul_nf4_jnp(jnp.asarray(x), jq, jnp.float32))
    tq = TL.quantize_linear_weight(_t(w), "nf4", group_size=gs)
    got = TL.quantized_matmul(_t(x), tq, torch.float32,
                              act_quant="all").numpy()
    assert counted == ([m] if route == "gemv" else [])
    tol = (dict(atol=1e-4, rtol=1e-5) if route == "table"
           else dict(atol=2e-2, rtol=1e-2))
    np.testing.assert_allclose(got, want, **tol)


def test_stochastic_affine_weights():
    """floor(w / s + u): each code is the floor or the floor + 1 of w / s
    plus the zero point, the codes are unbiased in the mean, one generator
    seed gives one result, and JAX's draws agree in distribution."""
    w = _w(256, 128, SEED + 6)
    near = TL.quantize_linear_weight(_t(w), 4)
    s = near.scale.numpy()
    z = near.zero_point.numpy()
    lo = np.clip(np.floor(w / s).astype(np.int64) + z, 0, 15)
    means = []
    for seed in range(8):
        q = TL.quantize_linear_weight(
            _t(w), 4, stochastic=True,
            generator=torch.Generator().manual_seed(seed))
        c = q.codes().numpy()
        assert ((c == lo) | (c == np.minimum(lo + 1, 15))).all()
        np.testing.assert_array_equal(q.scale.numpy(), s)
        means.append(q.dequantize(torch.float32).numpy())
    again = TL.quantize_linear_weight(
        _t(w), 4, stochastic=True, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(
        again.data.numpy(),
        TL.quantize_linear_weight(
            _t(w), 4, stochastic=True,
            generator=torch.Generator().manual_seed(0)).data.numpy())
    # unbiased: the mean over 8 draws of 32768 weights tracks w far closer
    # than one nearest rounding's step (s / sqrt(8 * 12) per weight)
    bias = float(np.mean(np.mean(means, 0) - w) / s.mean())
    assert abs(bias) < 0.01, bias
    jq = JL.quantize_linear_weight(jnp.asarray(w), 4, stochastic=True,
                                   key=jax.random.key(SEED))
    jerr = np.asarray(jq.dequantize(jnp.float32)) - w
    terr = means[0] - w
    assert abs(np.abs(jerr).mean() - np.abs(terr).mean()) < 0.05 * s.mean()
    with pytest.raises(ValueError):
        TL.quantize_linear_weight(_t(w), 4, stochastic=True)


@pytest.mark.parametrize("kw", [
    dict(bits="nf4", lm_head_bits=8), dict(bits="nf4", group_size=64),
    dict(bits=4, lm_head_bits=8, mlp_bits="nf4", mlp_group_size=32)],
    ids=["nf4", "nf4_g64", "int4_nf4_mlp"])
def test_random_nf4_params_follow_the_reference(kw):
    """random_quantized_params at NF4 against JAX's: the same bits,
    codebook, group size, shapes, absmax scale 1/sqrt(K) and zero zero
    point per weight; only the random codes differ."""
    jcfg = JM.LlamaConfig(**KCFG)
    j = JM.random_quantized_params(jcfg, jax.random.key(1), **kw)
    t = TM.random_quantized_params(convert.config_from_jax(jcfg), 1,
                                   device="cpu", **kw)
    pairs = [(jl[k], tl[k]) for jl, tl in zip(j["layers"], t["layers"])
             for k in TM._QUANT_KEYS]
    if "lm_head_bits" in kw:
        pairs.append((j["lm_head"], t["lm_head"]))
    assert any(a.codebook == "nf4" for a, _ in pairs)
    for a, b in pairs:
        assert (b.bits, b.k, b.group_size, b.codebook) == (
            a.bits, a.k, a.group_size, a.codebook)
        assert tuple(b.data.shape) == a.data.shape
        for f in ("scale", "zero_point", "s_chunk", "z_chunk"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                np.testing.assert_array_equal(y.float().numpy(),
                                              np.asarray(x, np.float32))


@pytest.mark.parametrize("kw", [dict(bits="nf4"),
                                dict(bits="nf4", group_size=64),
                                dict(bits=4, overrides={
                                    k: ("nf4", 32) for k in ("w1", "w3", "w2")})],
                         ids=["nf4", "nf4_g64", "int4_nf4_g32_mlp"])
def test_nf4_model_matches_jax(kw, counted):
    """The tiny model (head_dim 128, every projection on the NF4 GEMV's
    gate) quantized to NF4 by both packages from one float init: every
    weight byte-equal; then prefill + 3 decode steps against JAX within
    LOGIT_TOL (tests/test_torch_model.py), argmax equal where there is no
    near tie.  JAX's CPU route takes the f32 table product, the port the
    accelerator's bf16 table values: 0.8-1.2% of the largest logit apart
    (channelwise and g64, two seeds each; tests/torch_logit_error.py),
    inside LOGIT_TOL's 1.5%."""
    jcfg = JM.LlamaConfig(**KCFG)
    jfloat = JM.init_params(jcfg, jax.random.key(SEED))
    jparams = JM.quantize_params(jfloat, **kw)
    cfg = convert.config_from_jax(jcfg)
    params = convert.params_from_jax(jparams, device=CPU)
    mine = TM.quantize_params(convert.params_from_jax(jfloat, device=CPU),
                              **kw)
    for jl, ml in zip(jparams["layers"], mine["layers"]):
        for k in TM._QUANT_KEYS:
            assert ml[k].codebook == jl[k].codebook
            for f in ("data", "scale", "zero_point"):
                np.testing.assert_array_equal(getattr(ml[k], f).numpy(),
                                              np.asarray(getattr(jl[k], f)))
    rng = np.random.default_rng(SEED)
    toks = jnp.asarray(rng.integers(1, cfg.vocab_size, (2, 128 + 3)),
                       jnp.int32)
    _check_logits(_run_port(cfg, params, toks, 3),
                  _run_jax(jcfg, jparams, toks, 3, jit=True))
    n_nf4 = sum(w.codebook == "nf4" for w in
                (params["layers"][0][k] for k in TM._QUANT_KEYS))
    assert len(counted) == 3 * n_nf4 * cfg.n_layers   # the decode steps


def test_nf4_moe_matches_jax(monkeypatch):
    """The tiny MoE (4 experts, top 2) at NF4: expert stacks byte-equal with
    their codebook; the ragged route declines an NF4 stack at any token
    count, so prefill and decode run dense-masked as in the reference; the
    logits within LOGIT_TOL of JAX's."""
    from piquant_tpu_torch.ops.cuda import ragged as TR

    jcfg = JM.LlamaConfig.tiny(n_experts=4, moe_top_k=2)
    jfloat = JM.init_params(jcfg, jax.random.key(SEED + 7))
    jparams = JM.quantize_params(jfloat, bits="nf4")
    cfg = convert.config_from_jax(jcfg)
    params = convert.params_from_jax(jparams, device=CPU)
    mine = TM.quantize_params(convert.params_from_jax(jfloat, device=CPU),
                              bits="nf4")
    for jl, ml, pl in zip(jparams["layers"], mine["layers"],
                          params["layers"]):
        for k in TM._MOE_QUANT_KEYS:
            assert ml[k].codebook == pl[k].codebook == "nf4"
            assert pl[k].expert(1).codebook == "nf4"
            for f in ("data", "scale", "zero_point"):
                np.testing.assert_array_equal(getattr(ml[k], f).numpy(),
                                              np.asarray(getattr(jl[k], f)))
    ragged = []
    monkeypatch.setattr(TR, "wq_ragged_plain",
                        lambda *a, **k: ragged.append(1))
    rng = np.random.default_rng(SEED + 7)
    toks = jnp.asarray(rng.integers(1, cfg.vocab_size, (2, 64 + 3)),
                       jnp.int32)
    _check_logits(_run_port(cfg, params, toks, 3),
                  _run_jax(jcfg, jparams, toks, 3))
    assert not ragged
