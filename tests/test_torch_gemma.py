"""Gemma-1, Gemma-2, Gemma-3 and Granite in the port against the JAX package
on the CPU: the four Gemma presets and their flags carried across, the
sandwich and q/k norms of head_dim 256 byte for byte, the (1 + w) norm, the
GeGLU activation, the embedding scale and the two rope tables against
JAX's own functions, the flash prefill plain version with the softcap and
the decode-attention plain version at head_dim 256 against the Pallas
kernels in interpret mode, kv4 appends at head_dim 256, the tiny models'
logits (Granite's multipliers too), the engine under Gemma-3's alternating
windows, and the CLI on each Gemma preset patched to a tiny width."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from piquant_tpu.models import llama as JM
from piquant_tpu.ops.pallas.decode_attn2 import (
    decode_attention_state as j_decode_state)
from piquant_tpu.ops.pallas.flash import flash_prefill_masked as j_flash
from piquant_tpu.quant import kv_cache as JKV
from piquant_tpu_torch import convert
from piquant_tpu_torch.models import llama as TM
from piquant_tpu_torch.ops.cuda import decode_attn2 as TDA
from piquant_tpu_torch.ops.cuda import flash as TF
from piquant_tpu_torch.quant import kv_cache as TKV
from piquant_tpu_torch.serving import __main__ as S
from test_torch_cuda import _context_f32_probs
from test_torch_kernels import _stacked_cache
from test_torch_kv4 import KV4_LOGIT_TOL, _random_kv4
from test_torch_model import LOGIT_TOL, _run_jax, _run_port
from test_torch_serving import (_engine_tokens, _port_forward, _prompts,
                                _single)
from token_guard import assert_tokens_match_guarded

SEED = 0x6E3
CPU = torch.device("cpu")
PRESETS = ("gemma_2b", "gemma_7b", "gemma2_9b", "gemma3_12b")


def _t(a):
    return convert.tensor_from_numpy(a, CPU)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, as the CLI tests: the models' many small ops
    stall on a thread pool whose cores the other test workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", PRESETS)
def test_presets_carry_across(preset):
    """config_from_jax of each preset equals the port's own preset, at the
    reference's published widths; every layer's window and locality agree
    with the reference's (sliding, chunk) pair and layer_is_local."""
    jcfg = getattr(JM.LlamaConfig, preset)()
    cfg = convert.config_from_jax(jcfg)
    assert cfg == getattr(TM.LlamaConfig, preset)()
    assert (cfg.head_dim, cfg.n_heads // cfg.n_kv_heads) == (
        jcfg.head_dim, jcfg.n_heads // jcfg.n_kv_heads) and cfg.head_dim == 256
    layers = range(cfg.n_layers)
    assert [cfg.layer_window(i) for i in layers] == [
        jcfg.layer_window(i) for i in layers]
    assert [cfg.layer_is_local(i) for i in layers] == [
        jcfg.layer_is_local(i) for i in layers]


# the Gemma-like config of the model tests: head_dim 256 through the
# override, a window of 64 that bites at T = 128, every other layer local
G1 = dict(norm_plus_one=True, mlp_act="gelu", scale_embed=True)
G2 = dict(G1, sandwich_norms=True, attn_softcap=50.0, final_softcap=30.0,
          attn_scale_override=256.0 ** -0.5, sliding_window=64,
          sliding_pattern=2)
G3 = dict(G1, sandwich_norms=True, qk_norm=True, rope_theta=1_000_000.0,
          attn_scale_override=256.0 ** -0.5, sliding_window=64,
          sliding_pattern=2, rope_theta_local=10_000.0,
          rope_linear_factor=8.0)
NORMS = ("attn_norm", "mlp_norm", "post_attn_norm", "post_mlp_norm",
         "q_norm", "k_norm")


def _gemma_cfg(**kw):
    return JM.LlamaConfig(**{**dict(vocab_size=256, d_model=256, n_layers=2,
                                    n_heads=2, n_kv_heads=1, d_ff=512,
                                    max_seq_len=256, head_dim_override=256),
                             **kw})


def _set_norms(jparams, seed):
    """Norm weights from the seed in [-0.5, 0.5): offsets from 1 under
    norm_plus_one, as a Gemma checkpoint stores them (the init's ones
    would scale every norm by 1 + w = 2)."""
    rng = np.random.default_rng(seed)
    for tree in jparams["layers"] + [jparams]:
        for k in NORMS + ("final_norm",):
            if k in tree:
                tree[k] = jnp.asarray(rng.uniform(-0.5, 0.5, tree[k].shape),
                                      tree[k].dtype)
    return jparams


def test_gemma_params_carry_across():
    """init_params, random_quantized_params and quantize_params give the
    reference's tree (the sandwich norms and head_dim-256 q/k norms float,
    of its shapes and dtypes); params_from_jax carries them byte for
    byte."""
    jcfg = _gemma_cfg(**G3)
    cfg = convert.config_from_jax(jcfg)
    jfloat = JM.init_params(jcfg, jax.random.key(SEED))
    keys = ("post_attn_norm", "post_mlp_norm", "q_norm", "k_norm")
    for mine, ref in ((TM.init_params(cfg, 1, device=CPU), jfloat),
                      (TM.random_quantized_params(cfg, 1, lm_head_bits=8,
                                                  device=CPU),
                       JM.random_quantized_params(jcfg, jax.random.key(1),
                                                  lm_head_bits=8))):
        for tl, jl in zip(mine["layers"], ref["layers"]):
            assert sorted(tl) == sorted(jl)
            for k in keys:
                assert tuple(tl[k].shape) == jl[k].shape
                np.testing.assert_array_equal(tl[k].float().numpy(),
                                              np.asarray(jl[k], np.float32))
    assert jfloat["layers"][0]["q_norm"].shape == (256,)
    jq = _set_norms(JM.quantize_params(jfloat, bits=4), SEED)
    tq = TM.quantize_params(convert.params_from_jax(jfloat, device=CPU), 4)
    got = convert.params_from_jax(jq, device=CPU)
    for tl, gl, jl in zip(tq["layers"], got["layers"], jq["layers"]):
        assert sorted(tl) == sorted(jl)
        for k in keys + ("attn_norm", "mlp_norm"):
            assert gl[k].dtype == torch.bfloat16 and not hasattr(tl[k], "bits")
            np.testing.assert_array_equal(
                gl[k].view(torch.int16).numpy(),
                np.asarray(jl[k]).view(np.int16))


# ---------------------------------------------------------------------------
# building blocks against JAX's own functions
# ---------------------------------------------------------------------------

def test_norm_geglu_and_embed_scale_match_jax():
    """rms_norm with plus_one (w + 1 in the weight's dtype) and the bf16
    embedding scale (sqrt(3584) = 59.866 rounds to 59.75) bit for bit
    against JAX; the GeGLU activation, GELU's tanh form, to f32 rounding
    (XLA's tanh and torch's differ in the last bits, 6e-7 at most here),
    where torch's default erf form is off by far more."""
    rng = np.random.default_rng(SEED)
    x = jnp.asarray(rng.normal(0, 3, (3, 5, 256)), jnp.bfloat16)
    w = jnp.asarray(rng.uniform(-0.5, 0.5, 256), jnp.bfloat16)
    for p1 in (False, True):
        want = np.asarray(JM.rms_norm(x, w, 1e-6, p1).astype(jnp.float32))
        got = TM.rms_norm(_t(np.asarray(x)), _t(np.asarray(w)), 1e-6, p1)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)
    g = rng.normal(0, 3, (7, 300)).astype(np.float32)
    g[0, :6] = [0.0, -0.0, 30.0, -30.0, 1e-3, -5.5]
    cfg = convert.config_from_jax(_gemma_cfg(**G1))
    want = np.asarray(jax.nn.gelu(jnp.asarray(g), approximate=True))
    got = TM._glu_act(cfg, _t(g)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    erf = torch.nn.functional.gelu(_t(g)).numpy()      # the trap
    assert np.abs(erf - want).max() > 1e-4
    for d in (2048, 3072, 3584, 3840):
        c = TM._dtype_const(d ** 0.5, torch.zeros(1, dtype=torch.bfloat16))
        assert float(c) == float(jnp.asarray(d ** 0.5, jnp.bfloat16))
    assert float(TM._dtype_const(3584 ** 0.5, torch.zeros(
        1, dtype=torch.bfloat16))) == 59.75


def test_rope_tables_match_jax():
    """Gemma-3's two rope tables, picked per layer: local layers take
    rope_theta_local unscaled, global ones rope_theta with inv /
    rope_linear_factor; cos and sin within f32 rounding of JAX's (the
    angle of position p rounds at p * 2^-24 of itself)."""
    jcfg = _gemma_cfg(**G3)
    cfg = convert.config_from_jax(jcfg)
    pos = np.arange(0, 4000, 7, dtype=np.int32)[None]
    tables = {}
    for li in range(cfg.n_layers):
        local = cfg.layer_is_local(li)
        jc, js = JM._rope_freqs(jcfg, jnp.asarray(pos), local=local)
        tc, ts = TM._rope_freqs(cfg, _t(pos), local)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=5e-4)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=5e-4)
        tables[local] = tc
    assert not torch.allclose(tables[True], tables[False])


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

# Flash output element by element: atol 2e-3, rtol 2e-2 (the causal flash
# bound, tests/test_torch_kernels.py).  The inputs have unit-normal q and k
# at twice the scale, so the scaled scores spread over several units and a
# cap of 5 bites; Gemma-2's 50 at scale 1/16 barely does.
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("rep", [1, 2, 8])
@pytest.mark.parametrize("window,softcap", [(None, 5.0), (64, 50.0)])
def test_flash_softcap_matches_pallas(d, rep, window, softcap):
    b, hkv, t = 1, 1, 256
    rng = np.random.default_rng(SEED + d + rep)
    q = rng.normal(0, 2, (b, hkv, rep, t, d)).astype(np.float32)
    k = rng.normal(0, 2, (b, hkv, t, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, hkv, t, d)).astype(np.float32)
    sm = 256.0 ** -0.5 if d == 256 else d ** -0.5
    with jax.enable_x64(False), pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), sm, window=window,
                                  softcap=softcap, interpret=True))
    launches = TF.flash_attn.launches
    got = TF.flash_prefill_masked(_t(q), _t(k), _t(v), sm, window=window,
                                  softcap=softcap)
    assert TF.flash_attn.launches == launches          # CPU: plain
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-2)
    uncapped = TF.flash_attn_plain(_t(q), _t(k), _t(v), sm, window)
    assert (uncapped - got).abs().max() > 1e-2          # the cap bites


# Peaked scores, as Gemma's are: q and k scaled so the scaled scores have a
# standard deviation of a quarter of the cap (4 uncapped), at T 1024, where
# the Pallas kernel takes two 512-key tiles and its running max moves.  A
# few keys then dominate a row, and one bf16 rounding of a dominant
# probability moves the context by more than flash's atol of 2e-3: the
# Pallas kernel and the plain version each stay within one rounding
# (`rounding_bound`) of the context with unrounded probabilities, and
# within the stated bound plus two roundings of each other.
@pytest.mark.parametrize("d,window,softcap", [(128, None, 5.0),
                                              (256, None, 50.0),
                                              (256, 300, 50.0),
                                              (256, None, None)])
def test_flash_peaked_scores_within_rounding(d, window, softcap):
    b, hkv, rep, t, sm = 1, 2, 2, 1024, 1 / 16
    spread = softcap / 4 if softcap else 4.0
    sig = (spread / (sm * d ** 0.5)) ** 0.5
    rng = np.random.default_rng(SEED + d + (window or 0))
    q = rng.normal(0, sig, (b, hkv, rep, t, d)).astype(np.float32)
    k = rng.normal(0, sig, (b, hkv, t, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, hkv, t, d)).astype(np.float32)
    with jax.enable_x64(False), pltpu.force_tpu_interpret_mode():
        ref = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), sm, window=window,
                                 softcap=softcap, interpret=True))
    tq, tk, tv = _t(q), _t(k), _t(v)
    got = TF.flash_attn_plain(tq, tk, tv, sm, window, softcap).numpy()
    exact = _context_f32_probs(tq, tk, tv, sm, window, softcap).numpy()
    r = TF.rounding_bound(tq, tk, tv, sm, window, softcap).numpy()
    for name, a in (("pallas", ref), ("plain", got)):
        over = np.abs(a - exact) - (1e-5 + r)
        assert over.max() <= 0, f"{name}: {over.max()} past one rounding"
    assert np.all(np.abs(got - ref) <= 2e-3 + 2e-2 * np.abs(ref) + 2 * r)
    if softcap:
        uncapped = TF.flash_attn_plain(tq, tk, tv, sm, window).numpy()
        assert np.any(np.abs(uncapped - got) > 2e-3 + 2e-2 * np.abs(got)
                      + 2 * r)                         # the cap bites


# Decode-attention state at head_dim 256, kv8 and kv4 (a position of 128
# bytes: dim j low, dim j + 128 high), with and without window starts:
# m to f32 rounding, l within 2e-2, the normalized context of each live row
# within atol 2e-3, rtol 2e-2 (test_decode_window_matches_pallas's
# bounds); the pos = 0 row keeps the reference's sentinel exactly.
@pytest.mark.parametrize("kv", ["kv8", "kv4"])
@pytest.mark.parametrize("windowed", [False, True])
def test_decode_d256_matches_pallas(kv, windowed):
    rng = np.random.default_rng(SEED + windowed + 2 * (kv == "kv4"))
    nl, b, hkv, rep, s, d, w = 2, 4, 2, 2, 1024, 256, 301
    if kv == "kv4":
        cache = _random_kv4(rng, nl, b, hkv, s, d)
    else:
        cache = _stacked_cache(rng, nl, b, hkv, s, d)
    q = rng.normal(0, 1, (b, hkv, rep, d)).astype(np.float32)
    pos = np.array([0, 37, 700, 1023], np.int32)
    starts = np.maximum(pos - (w - 1), 0) if windowed else None
    wrapper = TDA.decode_attn2_kv4 if kv == "kv4" else TDA.decode_attn2
    sm = 256.0 ** -0.5
    for layer in (0, 1):
        with jax.enable_x64(False):
            jst = j_decode_state(
                jnp.asarray(q), *(jnp.asarray(a) for a in cache),
                jnp.asarray(pos), sm, layer=layer,
                starts=None if starts is None else jnp.asarray(starts),
                interpret=True)
            acc, m, l = (np.asarray(a) for a in jst)
        launches = wrapper.launches
        tst = TDA.decode_attention_state(
            _t(q), *(_t(a) for a in cache), _t(pos), sm, layer=layer,
            starts=None if starts is None else _t(starts))
        assert wrapper.launches == launches                # CPU: plain
        tacc, tm, tl = (a.numpy() for a in tst)
        assert (tm[0] == -1e30).all() and (tl[0] == 0).all()
        assert (tacc[0] == 0).all()
        np.testing.assert_allclose(tm, m, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tl, l, rtol=2e-2)
        np.testing.assert_allclose(tacc[1:] / tl[1:], acc[1:] / l[1:],
                                   atol=2e-3, rtol=2e-2)


def test_kv4_appends_d256_byte_equal():
    """pack4 at head_dim 256 (byte j: dim j low, dim j + 128 high): a
    prefill at an odd start and a deferred decode write on either half of a
    pair row give codes and scales byte-equal to JAX's."""
    rng = np.random.default_rng(SEED + 9)
    nl, b, h, s, d = 2, 2, 2, 32, 256
    jc = jax.tree.map(lambda a: jnp.stack([a] * nl),
                      JKV.kv_cache_init(b, h, s, d, bits=4))
    one = TKV.kv_cache_init(b, h, s, d, bits=4, device="cpu")
    tc = TKV.KVCache(*(torch.stack([a] * nl) for a in one.tensors()))

    def same():
        for f in ("k_codes", "v_codes", "k_scale", "v_scale", "length"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                          np.asarray(getattr(jc, f)),
                                          err_msg=f)

    for layer, start, t in ((0, 0, s), (1, 0, s), (1, 5, 8)):
        k, v = (rng.normal(0, 1, (b, h, t, d)).astype(np.float32)
                for _ in range(2))
        pos = np.broadcast_to(np.arange(start, start + t, dtype=np.int32),
                              (b, t))
        jc = JKV.kv_cache_append_stacked(jc, layer, jnp.asarray(k),
                                         jnp.asarray(v), jnp.asarray(pos),
                                         contiguous_start=jnp.int32(start))
        tc = TKV.kv_cache_append_stacked(tc, layer, _t(k), _t(v), _t(pos),
                                         contiguous_start=start)
        same()
    kk, vv = (rng.normal(0, 1, (nl, b, h, 1, d)).astype(np.float32)
              for _ in range(2))
    jkc, jks = JKV._quantize_sym(jnp.asarray(kk), 4)
    jvc, jvs = JKV._quantize_sym(jnp.asarray(vv), 4)
    pos = np.array([[12], [31]], np.int32)
    jc = JKV.kv_cache_append_stacked_batch(jc, jkc, jks, jvc, jvs,
                                           jnp.asarray(pos))
    tkc, tks = TKV._quantize_sym(_t(kk), 4)
    tvc, tvs = TKV._quantize_sym(_t(vv), 4)
    np.testing.assert_array_equal(tkc.numpy(), np.asarray(jkc))
    tc = TKV.kv_cache_append_stacked_batch(tc, tkc, tks, tvc, tvs, _t(pos))
    same()


# ---------------------------------------------------------------------------
# tiny models against JAX
# ---------------------------------------------------------------------------

def _setup(jcfg, seed):
    jparams = _set_norms(
        JM.quantize_params(JM.init_params(jcfg, jax.random.key(seed)),
                           bits=4), seed)
    return (jparams, convert.config_from_jax(jcfg),
            convert.params_from_jax(jparams, device=CPU))


def _check(got, want, tol):
    """Logits within tol of the largest; the argmax may differ only where
    the reference's top-2 is a near tie (tests/test_torch_model.py)."""
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err
    top2 = np.sort(want, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > 0.02
    assert (got.argmax(-1) == want.argmax(-1))[decisive].all()


# Each family's tiny model at head_dim 256: prefill of a 128-token prompt
# (the port's flash plain version, with the softcap under Gemma-2; JAX
# materializes scores on the CPU) and 3 decode steps (Gemma-2: the
# materialized softcap path on both sides; Gemma-1/3: the port's
# decode_attn2 plain version, with window starts on Gemma-3's local layer
# only), within LOGIT_TOL (kv8) or KV4_LOGIT_TOL (kv4).  JAX runs eagerly:
# under jit XLA on the CPU keeps bf16 intermediates in f32 (excess
# precision), which the port, rounding op by op as eager JAX does, does not
# follow; the sandwich norms of Gemma-2/3 lift the jit gap to 1.6-3% (kv8),
# against 0.4-1.4% eagerly (my runs, three seeds).
FAMILIES = {"gemma1": G1, "gemma2": G2, "gemma3": G3}


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_gemma_logits_match_jax(monkeypatch, family, kv_bits):
    jcfg = _gemma_cfg(kv_bits=kv_bits, **FAMILIES[family])
    jparams, cfg, params = _setup(jcfg, SEED + len(family) + kv_bits)
    rng = np.random.default_rng(SEED + kv_bits)
    toks = jnp.asarray(rng.integers(1, cfg.vocab_size, (2, 128 + 3)),
                       jnp.int32)
    calls = {"flash": [], "decode": []}
    flash, decode = TF.flash_attn_plain, TDA.decode_attn2_plain
    monkeypatch.setattr(TF, "flash_attn_plain", lambda *a: (
        calls["flash"].append(a[4:]), flash(*a))[1])
    monkeypatch.setattr(TDA, "decode_attn2_plain", lambda *a: (
        calls["decode"].append(a[6].tolist()), decode(*a))[1])
    got = _run_port(cfg, params, toks, 3)
    _check(got, _run_jax(jcfg, jparams, toks, 3),
           KV4_LOGIT_TOL if kv_bits == 4 else LOGIT_TOL)
    cap = cfg.attn_softcap
    # (window, softcap, chunk, pos0, sinks)
    assert calls["flash"] == [(cfg.layer_window(i)[0], cap, None, None, None)
                              for i in range(cfg.n_layers)]
    if cap:                     # Gemma-2: decode leaves the kernel
        assert calls["decode"] == []
        return
    assert len(calls["decode"]) == 3 * cfg.n_layers
    for j, starts in enumerate(calls["decode"]):
        w, _ = cfg.layer_window(j % cfg.n_layers)
        want = 0 if w is None else max(128 + j // cfg.n_layers - (w - 1), 0)
        assert starts == [want, want]
    if family == "gemma3":
        assert calls["decode"][0][0] > 0 and calls["decode"][1] == [0, 0]


@pytest.mark.heavy_interpret
def test_gemma2_logits_match_jax_kernels(monkeypatch):
    """The Gemma-2-like model with JAX forced onto its own Pallas kernels
    (interpret mode): the native flash kernel's softcap and window
    branches at head_dim 256 at prefill (its decode stays materialized
    under the softcap, as the port's)."""
    monkeypatch.setenv("PIQUANT_ATTN2", "force")
    monkeypatch.setenv("PIQUANT_FLASH", "force")
    monkeypatch.setenv("PIQUANT_FLASH_IMPL", "native")
    jcfg = _gemma_cfg(**G2)
    jparams, cfg, params = _setup(jcfg, SEED + 1)
    rng = np.random.default_rng(SEED + 1)
    toks = jnp.asarray(rng.integers(1, cfg.vocab_size, (2, 128 + 3)),
                       jnp.int32)
    with jax.enable_x64(False):
        want = _run_jax(jcfg, jparams, toks, 3)
    _check(_run_port(cfg, params, toks, 3), want, LOGIT_TOL)


def test_granite_logits_match_jax():
    """Granite's three multipliers on the tiny head_dim-128 Llama: the
    embedding scaled by embed_multiplier, the block outputs by
    residual_multiplier before the residual add, the logits divided by
    logits_scaling; prefill and 3 decode steps within LOGIT_TOL."""
    jcfg = JM.LlamaConfig(vocab_size=256, d_model=256, n_layers=2,
                          n_heads=2, n_kv_heads=1, d_ff=512, max_seq_len=256,
                          embed_multiplier=12.0, residual_multiplier=0.22,
                          logits_scaling=8.0)
    jparams = JM.quantize_params(JM.init_params(jcfg, jax.random.key(SEED)),
                                 bits=4)
    cfg = convert.config_from_jax(jcfg)
    params = convert.params_from_jax(jparams, device=CPU)
    rng = np.random.default_rng(SEED + 3)
    toks = jnp.asarray(rng.integers(1, cfg.vocab_size, (2, 128 + 3)),
                       jnp.int32)
    got = _run_port(cfg, params, toks, 3)
    _check(got, _run_jax(jcfg, jparams, toks, 3), LOGIT_TOL)
    plain = dataclasses.replace(cfg, embed_multiplier=None,
                                residual_multiplier=1.0, logits_scaling=1.0)
    assert np.abs(_run_port(plain, params, toks, 3) - got).max() > 0.1


def test_engine_gemma3_matches_single_request():
    """The engine under Gemma-3's alternating windows (16 on the local
    layer; prompts and generations past it; prefills of whole 128-position
    tiles through flash): greedy tokens equal single-request generation
    under the near-tie guard."""
    jcfg = _gemma_cfg(**{**G3, "sliding_window": 16, "max_seq_len": 128})
    _, cfg, params = _setup(jcfg, SEED + 2)
    prompts = _prompts(3, 100, 120, cfg.vocab_size, SEED + 2)
    _, done = _engine_tokens(cfg, params, prompts, 6, batch_slots=2,
                             max_seq_len=128, prefill_pad=128)
    fwd = _port_forward(cfg, params)
    for p, req in zip(prompts, done):
        assert_tokens_match_guarded(fwd, p, req.tokens,
                                    _single(cfg, params, p, 6),
                                    tag=f"rid {req.rid}")


# ---------------------------------------------------------------------------
# the CLI on each Gemma preset, patched to a tiny width
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=256, d_model=256, n_layers=2, n_heads=2,
            n_kv_heads=1, d_ff=512, max_seq_len=256)


@pytest.mark.parametrize("preset", PRESETS)
def test_cli_gemma_presets(monkeypatch, preset):
    """`--random <preset> --device cpu --benchmark 2` with the preset at a
    tiny width keeping its family flags (head_dim 256; windows cut to 32 on
    every other layer, so they bite on the CLI's prompts): both requests
    complete; gemma_7b, gemma2_9b and gemma3_12b from random codes with the
    INT8 lm_head, gemma_2b quantized from a float init with its bf16
    lm_head, as the reference CLI builds them."""
    full = getattr(TM.LlamaConfig, preset)()
    flags = dict(sliding_window=full.sliding_window and 32,
                 sliding_pattern=full.sliding_pattern and 2)
    small = dataclasses.replace(full, **{**TINY, **flags})
    monkeypatch.setattr(TM.LlamaConfig, preset, staticmethod(lambda: small))
    args = S.build_parser().parse_args(
        ["--random", preset, "--device", "cpu", "--benchmark", "2",
         "--slots", "2", "--max-new", "4", "--max-seq-len", "256"])
    cfg, params, eng, sp = S.build(args)
    assert dataclasses.replace(cfg, kv_bits=8) == small
    assert cfg.head_dim == 256
    layer = params["layers"][0]
    assert layer["wq"].bits == 4
    if preset == "gemma_2b":
        assert params["lm_head"].dtype == torch.bfloat16
    else:
        assert params["lm_head"].bits == 8
    assert ("post_attn_norm" in layer) == full.sandwich_norms
    assert ("q_norm" in layer) == full.qk_norm
    m, done = S.benchmark(args, cfg, eng, sp)
    assert m["completed"] == 2 and m["decode_tokens"] == 2 * 3
    for r in done:
        assert len(r.tokens) == 4 and all(0 <= t < 256 for t in r.tokens)
        assert all(np.isfinite(lp) and lp <= 0 for lp in r.logprobs)
