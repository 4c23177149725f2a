"""The pair-packed kv4 cache of the port against the JAX package on the CPU:
packing and quantization byte for byte, the cache bytes after every append
pattern, decode attention over it (the plain version against the Pallas
kernel in interpret mode), the tiny model's logits, a JAX cache carried
across, and the engine's greedy tokens."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from piquant_tpu.models import llama as JM
from piquant_tpu.ops.pallas.decode_attn2 import (
    decode_attention_state as j_decode_state)
from piquant_tpu.quant import kv_cache as JKV
from piquant_tpu_torch import convert
from piquant_tpu_torch.models import llama as TM
from piquant_tpu_torch.ops.cuda import decode_attn2 as TDA
from piquant_tpu_torch.quant import kv_cache as TKV
from piquant_tpu_torch.serving import Engine, EngineConfig
from test_torch_model import KCFG, _run_jax, _run_port
from test_torch_serving import (_engine_tokens, _port_forward, _prompts,
                                _single)
from tests.token_guard import assert_tokens_match_guarded

SEED = 0x4B34
CPU = torch.device("cpu")

# Whole-model logits at kv4: max |port - jax| <= KV4_LOGIT_TOL * max |jax|.
# JAX's own kv4 decode logits lie 4.4-6.3% (of the largest logit) from its
# model's float-K/V forward on these configs (kv8: 0.6-0.8%), over three
# seeds each (tests/torch_logit_error.py); a K or V value that the two
# packages' bf16 activations put on opposite sides of a kv4 rounding
# boundary moves by a whole code, 1/7 of its row's absmax, so the
# cross-package band is wider than kv8's LOGIT_TOL too.  3e-2 is about 2.5
# times the 1.0-1.2% that script measures between the packages.
KV4_LOGIT_TOL = 3e-2


def _t(a):
    return convert.tensor_from_numpy(a, CPU)


def _check_logits(got, want, tol=KV4_LOGIT_TOL):
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err
    # the argmax may only differ where the reference's top-2 is a near tie
    top2 = np.sort(want, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > 0.02
    assert (got.argmax(-1) == want.argmax(-1))[decisive].all()


def test_pack4_and_scale_pairs_match_jax():
    rng = np.random.default_rng(SEED)
    codes = rng.integers(-7, 8, (2, 3, 6, 16)).astype(np.int8)
    scale = rng.random((2, 3, 6, 1)).astype(np.float32)
    for fn in ("pack4", "pack4_pairs"):
        got = getattr(TKV, fn)(_t(codes))
        want = np.asarray(getattr(JKV, fn)(jnp.asarray(codes)))
        np.testing.assert_array_equal(got.numpy(), want)
        back = {"pack4": TKV.unpack4, "pack4_pairs": TKV.unpack4_pairs}[fn]
        np.testing.assert_array_equal(back(got).numpy(), codes)
    s2 = TKV.split_scale_pairs(_t(scale))
    np.testing.assert_array_equal(
        s2.numpy(), np.asarray(JKV.split_scale_pairs(jnp.asarray(scale))))
    np.testing.assert_array_equal(TKV.merge_scale_pairs(s2).numpy(), scale)
    with pytest.raises(ValueError):
        TKV.pack4_pairs(_t(codes[:, :, :5]))


def test_quantize_sym_kv4_byte_equal():
    """Codes in [-7, 7], rounded half to even, pack4'ed; f32 scales."""
    x = np.random.default_rng(SEED + 1).normal(0, 1, (2, 2, 5, 16))
    x = x.astype(np.float32)
    x[0, 0, 0, :4] = [0.5, 1.5, -2.5, 7.0]        # ties at scale 1
    jc, js = JKV._quantize_sym(jnp.asarray(x), 4)
    tc, ts = TKV._quantize_sym(_t(x), 4)
    assert tc.dtype == torch.uint8 and tc.shape[-1] == 8
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_kv_cache_init_kv4():
    c = TKV.kv_cache_init(2, 3, 10, 16, bits=4, device="cpu")
    assert c.k_codes.shape == (2, 3, 5, 16) and c.k_codes.dtype == torch.uint8
    assert c.k_scale.shape == (2, 3, 2, 5) and c.bits == 4
    assert c.max_len == TKV.cache_max_len(c) == 10
    j = JKV.kv_cache_init(2, 3, 10, 16, bits=4)
    for f in ("k_codes", "v_codes", "k_scale", "v_scale", "length"):
        assert tuple(getattr(c, f).shape) == getattr(j, f).shape
    for kw in (dict(head_dim=15), dict(max_len=9), dict(bits=6)):
        args = dict(batch=1, n_kv_heads=1, max_len=8, head_dim=16, bits=4)
        with pytest.raises(ValueError):
            TKV.kv_cache_init(**{**args, **kw}, device="cpu")


NL, B, H, S, D = 2, 2, 2, 32, 16


def _stacked_pair():
    one_j = JKV.kv_cache_init(B, H, S, D, bits=4)
    one_t = TKV.kv_cache_init(B, H, S, D, bits=4, device="cpu")
    return (jax.tree.map(lambda a: jnp.stack([a] * NL), one_j),
            TKV.KVCache(*(torch.stack([a] * NL) for a in one_t.tensors())))


def _same(jc, tc):
    for f in ("k_codes", "v_codes", "k_scale", "v_scale", "length"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)


def _prefill(jc, tc, rng, layer, start, t):
    k = rng.normal(0, 1, (B, H, t, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, H, t, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(start, start + t, dtype=np.int32), (B, t))
    jc = JKV.kv_cache_append_stacked(jc, layer, jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(pos),
                                     contiguous_start=jnp.int32(start))
    tc = TKV.kv_cache_append_stacked(tc, layer, _t(k), _t(v), _t(pos),
                                     contiguous_start=start)
    return jc, tc


def _decode(jc, tc, rng, pos):
    kk = rng.normal(0, 1, (NL, B, H, 1, D)).astype(np.float32)
    vv = rng.normal(0, 1, (NL, B, H, 1, D)).astype(np.float32)
    jkc, jks = JKV._quantize_sym(jnp.asarray(kk), 4)
    jvc, jvs = JKV._quantize_sym(jnp.asarray(vv), 4)
    tkc, tks = TKV._quantize_sym(_t(kk), 4)
    tvc, tvs = TKV._quantize_sym(_t(vv), 4)
    pos = np.array(pos, np.int32)
    jc = JKV.kv_cache_append_stacked_batch(jc, jkc, jks, jvc, jvs,
                                           jnp.asarray(pos))
    tc = TKV.kv_cache_append_stacked_batch(tc, tkc, tks, tvc, tvs, _t(pos))
    return jc, tc


# Each append pattern on a cache whose every pair row already holds two
# positions (a prefill over the whole length first), so a write that
# clobbers the other half of a pair row, or the other parity's scale,
# shows: codes, scales and lengths byte-equal to the reference after it.
PATTERNS = {
    "prefill_even_start": lambda jc, tc, r: _prefill(jc, tc, r, 1, 4, 8),
    "prefill_odd_start": lambda jc, tc, r: _prefill(jc, tc, r, 0, 5, 8),
    "prefill_odd_length": lambda jc, tc, r: _prefill(jc, tc, r, 1, 2, 7),
    "decode_even_odd": lambda jc, tc, r: _decode(jc, tc, r, [[12], [31]]),
    "decode_last_pair": lambda jc, tc, r: _decode(jc, tc, r, [[30], [31]]),
    # past max_len: dropped, the last pair row and its scales untouched
    "decode_out_of_range": lambda jc, tc, r: _decode(jc, tc, r, [[32], [33]]),
    "decode_one_out_of_range": lambda jc, tc, r: _decode(jc, tc, r,
                                                         [[35], [7]]),
}


@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_kv4_appends_byte_equal(pattern):
    rng = np.random.default_rng(SEED + 2)
    jc, tc = _stacked_pair()
    for layer in range(NL):
        jc, tc = _prefill(jc, tc, rng, layer, 0, S)
    _same(jc, tc)
    jc, tc = PATTERNS[pattern](jc, tc, rng)
    _same(jc, tc)


@pytest.mark.parametrize("bits", [4, 8])
def test_unstacked_append_and_read_match_jax(bits):
    """The unstacked kv_cache_append at scattered positions (an odd and an
    even one in one row, one past the cache, which is dropped) and
    kv_cache_read."""
    rng = np.random.default_rng(SEED + 3)
    jc = JKV.kv_cache_init(B, H, S, D, bits=bits)
    tc = TKV.kv_cache_init(B, H, S, D, bits=bits, device="cpu")
    for pos in ([[0, 1, 2], [4, 5, 6]], [[9, 12, 31], [33, 3, 30]]):
        k = rng.normal(0, 1, (B, H, 3, D)).astype(np.float32)
        v = rng.normal(0, 1, (B, H, 3, D)).astype(np.float32)
        p = np.array(pos, np.int32)
        jc = JKV.kv_cache_append(jc, jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(p))
        tc = TKV.kv_cache_append(tc, _t(k), _t(v), _t(p))
        _same(jc, tc)
    for a, b in zip(TKV.kv_cache_read(tc, torch.float32),
                    JKV.kv_cache_read(jc, jnp.float32)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _random_kv4(rng, nl, b, hkv, s, d):
    codes = [rng.integers(0, 256, (nl, b, hkv, s // 2, d)).astype(np.uint8)
             for _ in range(2)]
    scales = [(rng.random((nl, b, hkv, 2, s // 2)) * 0.02).astype(np.float32)
              for _ in range(2)]
    return codes[0], scales[0], codes[1], scales[1]


# Decode-attention state over the kv4 cache, as the kv8 test in
# tests/test_torch_kernels.py: m to f32 rounding, l within 2e-2, the
# normalized context of each live row within atol 2e-3, rtol 2e-2 (bf16
# probabilities before PV at other running maxima); the pos = 0 row keeps
# the reference's sentinel exactly.  Odd positions and odd starts put live
# windows on both halves of a pair row.
def test_decode_attn2_kv4_matches_pallas():
    rng = np.random.default_rng(SEED + 4)
    nl, b, hkv, rep, s, d = 2, 4, 2, 4, 1024, 128
    kc, ks, vc, vs = _random_kv4(rng, nl, b, hkv, s, d)
    q = rng.normal(0, 1, (b, hkv, rep, d)).astype(np.float32)
    pos = np.array([0, 37, 701, 1024], np.int32)
    starts = np.array([0, 5, 513, 0], np.int32)
    for layer in (0, 1):
        with jax.enable_x64(False):
            jst = j_decode_state(
                jnp.asarray(q), *(jnp.asarray(a) for a in (kc, ks, vc, vs)),
                jnp.asarray(pos), d ** -0.5, layer=layer,
                starts=jnp.asarray(starts), interpret=True)
            acc, m, l = (np.asarray(a) for a in jst)
        launches = TDA.decode_attn2_kv4.launches
        tst = TDA.decode_attention_state(
            _t(q), *(_t(a) for a in (kc, ks, vc, vs)), _t(pos), d ** -0.5,
            layer=layer, starts=_t(starts))
        assert TDA.decode_attn2_kv4.launches == launches   # CPU: plain
        tacc, tm, tl = (a.numpy() for a in tst)
        assert (tm[0] == -1e30).all() and (tl[0] == 0).all()
        assert (tacc[0] == 0).all()
        np.testing.assert_array_equal(tm[0], m[0])
        np.testing.assert_allclose(tm, m, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tl, l, rtol=2e-2)
        np.testing.assert_allclose(tacc[1:] / tl[1:], acc[1:] / l[1:],
                                   atol=2e-3, rtol=2e-2)


def test_decode_attention_state_kv4_gates():
    """kv4 takes the kernel (its plain version here) at any even length,
    with no lane gate on the chunk; scales not parity-split decline."""
    rng = np.random.default_rng(SEED + 5)
    kc, ks, vc, vs = _random_kv4(rng, 1, 1, 1, 192, 128)
    q = torch.zeros(1, 1, 2, 128)
    pos = torch.tensor([100], dtype=torch.int32)
    st = TDA.decode_attention_state(q, _t(kc), _t(ks), _t(vc), _t(vs), pos,
                                    1.0, layer=0)
    assert st is not None and st[0].shape == (1, 1, 2, 128)
    flat = _t(ks).reshape(1, 1, 1, 192, 1)
    assert TDA.decode_attention_state(q, _t(kc), flat, _t(vc), flat, pos,
                                      1.0, layer=0) is None


@pytest.mark.heavy_interpret
@pytest.mark.parametrize("which", ["kernel_shapes", "tiny"])
def test_kv4_model_matches_jax(which, monkeypatch):
    """Prefill + 3 decode steps at kv_bits=4 against JAX forced onto its
    decode_attn2 kernel (interpret mode) where the head_dim takes it
    (kernel_shapes: both packages through the kernel path; tiny, head_dim
    32: both through the materialized pair-packed read)."""
    monkeypatch.setenv("PIQUANT_ATTN2", "force")
    base = (JM.LlamaConfig(**KCFG) if which == "kernel_shapes"
            else JM.LlamaConfig.tiny())
    jcfg = dataclasses.replace(base, kv_bits=4)
    jparams = JM.quantize_params(JM.init_params(jcfg, jax.random.key(SEED)),
                                 bits=4)
    cfg = convert.config_from_jax(jcfg)
    assert cfg.kv_bits == 4
    params = convert.params_from_jax(jparams, device=CPU)
    rng = np.random.default_rng(SEED)
    toks = jnp.asarray(rng.integers(1, cfg.vocab_size, (2, 128 + 3)),
                       jnp.int32)
    with jax.enable_x64(False):
        want = _run_jax(jcfg, jparams, toks, 3, jit=True)
    _check_logits(_run_port(cfg, params, toks, 3), want)


def test_decode_from_jax_kv4_cache():
    """A kv4 cache filled by the JAX prefill (an odd prompt length, so the
    last pair row is half full), carried across byte for byte: the port's
    decode step from it matches JAX's, and writes the odd half."""
    jcfg = JM.LlamaConfig(**{**KCFG, "kv_bits": 4})
    jparams = JM.quantize_params(JM.init_params(jcfg, jax.random.key(SEED + 6)),
                                 bits=4)
    cfg = convert.config_from_jax(jcfg)
    params = convert.params_from_jax(jparams, device=CPU)
    rng = np.random.default_rng(SEED + 6)
    toks = jnp.asarray(rng.integers(1, cfg.vocab_size, (2, 128)), jnp.int32)
    jcache = JM.init_kv_cache(jcfg, 2, max_len=jcfg.max_seq_len)
    _, jcache = JM.prefill(jcfg, jparams, toks[:, :127], jcache)
    cache = convert.kv_cache_from_jax(jcache, device=CPU)
    _same(jcache, cache)
    pos = np.full((2,), 127, np.int32)
    want, jcache = JM.decode_step(jcfg, jparams, toks[:, 127],
                                  jnp.asarray(pos), jcache)
    got, cache = TM.decode_step(cfg, params,
                                torch.from_numpy(np.array(toks[:, 127])),
                                torch.from_numpy(pos), cache)
    _check_logits(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(cache.length.numpy(),
                                  np.asarray(jcache.length))
    # position 127: the odd half of pair row 63, beside position 126
    assert (cache.k_scale[:, :, :, 1, 63] > 0).all()
    np.testing.assert_array_equal(cache.k_scale[:, :, :, 0, 63].numpy(),
                                  np.asarray(jcache.k_scale)[:, :, :, 0, 63])


@pytest.fixture(scope="module")
def kv4_setup():
    jcfg = JM.LlamaConfig(**{**KCFG, "max_seq_len": 128, "kv_bits": 4})
    jparams = JM.quantize_params(JM.init_params(jcfg, jax.random.key(SEED)),
                                 bits=4)
    return convert.config_from_jax(jcfg), convert.params_from_jax(
        jparams, device=CPU)


def test_engine_kv4_matches_single_request_generation(kv4_setup):
    """Bursts of one pad bucket prefilled together and copied into the
    slots' pair-packed rows (half the width in code rows and scale
    columns): greedy tokens equal the port's own single-request
    generation, under the near-tie guard."""
    cfg, params = kv4_setup
    prompts = _prompts(5, 3, 12, cfg.vocab_size, SEED)
    eng, done = _engine_tokens(cfg, params, prompts, 6, batch_slots=2,
                               max_seq_len=128, prefill_pad=4)
    fwd = _port_forward(cfg, params)
    for p, req in zip(prompts, done):
        assert_tokens_match_guarded(fwd, p, req.tokens,
                                    _single(cfg, params, p, 6),
                                    tag=f"rid {req.rid}")
    assert eng.cache.k_codes.dtype == torch.uint8
    with pytest.raises(ValueError):
        Engine(cfg, params, EngineConfig(max_seq_len=128, prefill_pad=5),
               device=CPU)
