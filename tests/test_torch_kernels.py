"""Port (piquant_tpu_torch) against the JAX package, kernel by kernel, on the
CPU: the same numpy inputs through the JAX function (its Pallas kernel in
interpret mode where it has one) and the port's counterpart, whose wrapper
runs the kernel's plain PyTorch version on CPU tensors."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from piquant_tpu.ops.pallas import qmatmul as JQ
from piquant_tpu.ops.pallas.decode_attn2 import (
    decode_attention_state as j_decode_state)
from piquant_tpu.ops.pallas.flash import flash_prefill_masked as j_flash
from piquant_tpu.quant import kv_cache as JKV
from piquant_tpu.quant.linear import quantize_linear_weight as j_quantize
from piquant_tpu_torch.convert import tensor_from_numpy
from piquant_tpu_torch.ops.cuda import decode_attn2 as TDA
from piquant_tpu_torch.ops.cuda import flash as TF
from piquant_tpu_torch.ops.cuda import qmatmul as TQ
from piquant_tpu_torch.ops.reference import round_half_away
from piquant_tpu_torch.quant import kv_cache as TKV
from piquant_tpu_torch.quant import linear as TL
from _torch_threads import one_thread  # noqa: F401

SEED = 0x7E57


def _t(a):
    return tensor_from_numpy(a, torch.device("cpu"))


def test_round_half_away_ties():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 0.49999997, 3.0])
    assert round_half_away(x).tolist() == [1.0, 2.0, 3.0, -1.0, -3.0, 1.0, 3.0]
    assert torch.round(x[:3]).tolist() == [0.0, 2.0, 2.0]   # half to even


# Bit-exact: the quantizer is the same f32 arithmetic op for op.
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("channelwise", [True, False])
def test_quantize_linear_weight_bit_exact(bits, channelwise):
    rng = np.random.default_rng(SEED + bits)
    w = rng.normal(0, 0.05, (256, 384)).astype(np.float32)
    w[:, 7] = 0.25                      # a constant column: span == 0
    jq = j_quantize(jnp.asarray(w), bits, channelwise=channelwise)
    tq = TL.quantize_linear_weight(_t(w), bits, channelwise=channelwise)
    np.testing.assert_array_equal(tq.data.numpy(), np.asarray(jq.data))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    np.testing.assert_array_equal(tq.zero_point.numpy(),
                                  np.asarray(jq.zero_point))
    codes = TL.unpack_split_half(tq.data) if bits == 4 else tq.data.int()
    if bits == 4:
        np.testing.assert_array_equal(TL.pack_split_half(codes).numpy(),
                                      np.asarray(jq.data))


# quantized_matmul f32 out: atol 2e-2, rtol 1e-2 — the bound the JAX tests
# hold the Pallas kernel to (tests/test_qmatmul.py); the sums run in f32 in
# another order.
@pytest.mark.parametrize("m,k,n,bits", [(1, 256, 512, 4), (8, 256, 512, 4),
                                        (33, 256, 512, 4), (8, 8704, 1024, 4),
                                        (8, 256, 512, 8)])
def test_quantized_matmul_matches_pallas(m, k, n, bits):
    """INT4: the GEMV's plain version against `_w4_kernel` (and, at K=8704,
    `_w4_kernel_ksplit`).  INT8: the dequant path against `_w8_kernel`."""
    rng = np.random.default_rng(SEED + m + k)
    w = rng.normal(0, 0.05, (k, n)).astype(np.float32)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    jq = j_quantize(jnp.asarray(w), bits)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JQ.quantized_matmul(jnp.asarray(x), jq, jnp.float32))
    tq = TL.quantize_linear_weight(_t(w), bits)
    launches = TQ.w4_gemv.launches
    got = TL.quantized_matmul(_t(x), tq, torch.float32)
    assert TQ.w4_gemv.launches == launches   # CPU tensors: plain version
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=1e-2)


def test_quantized_matmul_routes():
    """M > 64 and N % 128 != 0 take the dequant path, as in the reference
    dispatch; both paths agree."""
    rng = np.random.default_rng(SEED)
    w = rng.normal(0, 0.05, (256, 512)).astype(np.float32)
    tq = TL.quantize_linear_weight(_t(w), 4)
    x = _t(rng.normal(0, 1, (80, 256)).astype(np.float32))
    assert TQ.quantized_matmul(x, tq) is None
    assert TQ.quantized_matmul(x[:8], tq) is not None
    w2 = TL.quantize_linear_weight(_t(w[:, :100]), 4)
    assert TQ.quantized_matmul(x[:8], w2) is None
    a = TL._matmul_dequant(x[:8], tq, torch.float32)
    b = TL.quantized_matmul(x[:8], tq, torch.float32)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-2, rtol=1e-2)


def _stacked_cache(rng, nl, b, hkv, s, d):
    """A stacked kv8 cache filled through the JAX quantizer."""
    k = rng.normal(0, 1, (nl, b, hkv, s, d)).astype(np.float32)
    v = rng.normal(0, 1, (nl, b, hkv, s, d)).astype(np.float32)
    kc, ks = JKV._quantize_sym(jnp.asarray(k))
    vc, vs = JKV._quantize_sym(jnp.asarray(v))
    return [np.asarray(a) for a in (kc, ks, vc, vs)]


# Decode-attention state: m to f32 rounding, l within 2e-2, and the
# normalized context of each live row element by element within atol 2e-3,
# rtol 2e-2.  Both packages round the probabilities to bf16 (relative error
# 2^-9 each) before the PV product, but at different running maxima (the
# kernels chunk the cache differently).
def test_decode_attention_state_matches_pallas():
    rng = np.random.default_rng(SEED + 1)
    nl, b, hkv, rep, s, d = 2, 4, 2, 4, 1024, 128
    kc, ks, vc, vs = _stacked_cache(rng, nl, b, hkv, s, d)
    q = rng.normal(0, 1, (b, hkv, rep, d)).astype(np.float32)
    pos = np.array([0, 37, 700, 1024], np.int32)
    starts = np.array([0, 5, 512, 0], np.int32)
    for layer in (0, 1):
        jst = j_decode_state(jnp.asarray(q), *(jnp.asarray(a) for a in (kc, ks, vc, vs)),
                             jnp.asarray(pos), d ** -0.5, layer=layer,
                             starts=jnp.asarray(starts), interpret=True)
        launches = TDA.decode_attn2.launches
        tst = TDA.decode_attention_state(_t(q), *(_t(a) for a in (kc, ks, vc, vs)),
                                         _t(pos), d ** -0.5, layer=layer,
                                         starts=_t(starts))
        assert TDA.decode_attn2.launches == launches
        acc, m, l = (np.asarray(a) for a in jst)
        tacc, tm, tl = (a.numpy() for a in tst)
        # pos == 0: the reference's sentinel state, exactly
        assert (tm[0] == -1e30).all() and (tl[0] == 0).all() and (tacc[0] == 0).all()
        np.testing.assert_array_equal(tm[0], m[0])
        np.testing.assert_allclose(tm, m, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tl, l, rtol=2e-2)
        np.testing.assert_allclose(tacc[1:] / tl[1:], acc[1:] / l[1:],
                                   atol=2e-3, rtol=2e-2)


def test_decode_attention_state_gates():
    q = torch.zeros(1, 1, 2, 64)
    kc = torch.zeros(1, 1, 1, 128, 64, dtype=torch.int8)
    ks = torch.zeros(1, 1, 1, 128, 1)
    pos = torch.zeros(1, dtype=torch.int32)
    assert TDA.decode_attention_state(q, kc, ks, kc, ks, pos, 1.0, layer=0) is None
    with pytest.raises(ValueError):   # the unstacked cache is not ported
        TDA.decode_attention_state(q, kc[0], ks[0], kc[0], ks[0], pos, 1.0,
                                   layer=0)
    # a kv4 cache whose scales are not parity-split declines, as in the
    # reference (the kv4 path: tests/test_torch_kv4.py)
    q128 = torch.zeros(1, 1, 2, 128)
    kc4 = torch.zeros(1, 1, 1, 64, 128, dtype=torch.uint8)
    assert TDA.decode_attention_state(q128, kc4, ks, kc4, ks, pos, 1.0,
                                      layer=0) is None


# Flash prefill output element by element: atol 2e-3, rtol 2e-2.  Both
# round the probabilities to bf16 (relative error 2^-9 each) before the PV
# product, at running maxima of another tile order; a row averaging t keys
# then errs by about 2^-9 / sqrt(t) of the value scale, and row 0 (one key)
# is v[0] in both.
@pytest.mark.parametrize("b,hkv,rep,t", [(1, 2, 2, 256), (2, 1, 4, 128)])
def test_flash_prefill_matches_pallas(b, hkv, rep, t):
    rng = np.random.default_rng(SEED + 2 + t)
    d = 128
    q = rng.normal(0, 1, (b, hkv, rep, t, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, hkv, t, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, hkv, t, d)).astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), d ** -0.5, interpret=True))
    launches = TF.flash_attn.launches
    got = TF.flash_prefill_masked(_t(q), _t(k), _t(v), d ** -0.5).numpy()
    assert TF.flash_attn.launches == launches
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-2)


# The options that raised until the chunk and sinks branches were ported
# now run: each against the Pallas kernel in interpret mode (atol 2e-3,
# rtol 2e-2, as above), sinks N(0, 1) and a chunk boundary inside the
# 128-row tile.
@pytest.mark.parametrize("option", [{"window": 96, "sinks": True},
                                    {"chunk": 128},
                                    {"chunk": 48, "softcap": 20.0},
                                    {"sinks": True},
                                    {"chunk": 80, "pos0": 30, "sinks": True}])
def test_flash_prefill_options_not_ported(option):
    b, hkv, rep, t, d = 1, 2, 2, 256, 128
    rng = np.random.default_rng(SEED + len(option))
    q = rng.normal(0, 1, (b, hkv, rep, t, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, hkv, t, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, hkv, t, d)).astype(np.float32)
    kw, jkw, tkw = dict(option), {}, {}
    if kw.pop("sinks", False):
        s = rng.normal(0, 1, (hkv, rep)).astype(np.float32)
        jkw["sinks"], tkw["sinks"] = jnp.asarray(s), _t(s)
    if "pos0" in kw:
        p0 = np.full((b,), kw.pop("pos0"), np.int32)
        jkw["pos0"], tkw["pos0"] = jnp.asarray(p0), _t(p0)
    with jax.enable_x64(False), pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), d ** -0.5, interpret=True,
                                  **kw, **jkw))
    got = TF.flash_prefill_masked(_t(q), _t(k), _t(v), d ** -0.5, **kw, **tkw)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-2)


def test_flash_prefill_gate():
    q = torch.zeros(1, 1, 1, 100, 128)
    k = torch.zeros(1, 1, 100, 128)
    assert TF.flash_prefill_masked(q, k, k, 1.0) is None


# Bit-exact: kv8 codes and scales (both round half to even), and both cache
# writes.
def test_kv_cache_writes_bit_exact():
    rng = np.random.default_rng(SEED + 3)
    nl, b, hkv, s, d, t = 2, 2, 2, 32, 16, 8
    k = rng.normal(0, 1, (b, hkv, t, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, hkv, t, d)).astype(np.float32)
    k[0, 0, 0, :4] = [0.5, 1.5, -2.5, 127.0]      # ties at scale 1
    jc, js = JKV._quantize_sym(jnp.asarray(k))
    tc, ts = TKV._quantize_sym(_t(k))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    def jcache():
        one = JKV.kv_cache_init(b, hkv, s, d)
        return jax.tree.map(lambda a: jnp.stack([a] * nl), one)

    def tcache():
        c = TKV.kv_cache_init(b, hkv, s, d, device="cpu")
        return TKV.KVCache(*(torch.stack([a] * nl) for a in c.tensors()))

    def same(jc_, tc_):
        for f in ("k_codes", "v_codes", "k_scale", "v_scale", "length"):
            np.testing.assert_array_equal(getattr(tc_, f).numpy(),
                                          np.asarray(getattr(jc_, f)))

    # contiguous prefill writes (the scattered per-layer write is held in
    # tests/test_torch_fused_engine.py::test_stacked_append_byte_equal)
    jc_, tc_ = jcache(), tcache()
    for layer, start in ((1, 4), (0, 0)):
        pos = np.broadcast_to(np.arange(start, start + t, dtype=np.int32),
                              (b, t))
        jc_ = JKV.kv_cache_append_stacked(jc_, layer, jnp.asarray(k),
                                          jnp.asarray(v), jnp.asarray(pos),
                                          contiguous_start=jnp.int32(start))
        tc_ = TKV.kv_cache_append_stacked(tc_, layer, _t(k), _t(v), _t(pos),
                                          contiguous_start=start)
        same(jc_, tc_)

    # deferred decode write: every layer's pre-quantized row in one scatter;
    # a position past the cache is dropped, as the reference's scatter does
    for p1 in ([[12], [31]], [[30], [32]], [[33], [7]]):
        kk = rng.normal(0, 1, (nl, b, hkv, 1, d)).astype(np.float32)
        vv = rng.normal(0, 1, (nl, b, hkv, 1, d)).astype(np.float32)
        jkc, jks = JKV._quantize_sym(jnp.asarray(kk))
        jvc, jvs = JKV._quantize_sym(jnp.asarray(vv))
        p1 = np.array(p1, np.int32)
        jc_ = JKV.kv_cache_append_stacked_batch(jc_, jkc, jks, jvc, jvs,
                                                jnp.asarray(p1))
        tc_ = TKV.kv_cache_append_stacked_batch(
            tc_, *(_t(np.asarray(a)) for a in (jkc, jks, jvc, jvs)), _t(p1))
        same(jc_, tc_)
