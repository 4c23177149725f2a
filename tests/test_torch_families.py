"""The Mistral, Qwen2, Qwen3, Phi-3 and Qwen3-MoE families in the port
against the JAX package on the CPU: the five presets and their family flags
(sliding window, q/k/v biases, qk-norm, partial rotary) carried across, the
windowed flash prefill and windowed decode attention (plain versions)
against the Pallas kernels in interpret mode at GQA reps the CUDA kernels
took only from this slice on, partial rope, the tiny models' logits, the
engine under a window, and the CLI on each preset patched to a tiny
width."""

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
from piquant_tpu_torch import convert
from piquant_tpu_torch.models import llama as TM
from piquant_tpu_torch.ops.cuda import decode_attn2 as TDA
from piquant_tpu_torch.ops.cuda import flash as TF
from piquant_tpu_torch.serving import __main__ as S
from test_torch_kernels import _stacked_cache
from test_torch_kv4 import _random_kv4
from test_torch_model import _check_logits, _run_jax, _run_port
from test_torch_serving import (_engine_tokens, _port_forward, _prompts,
                                _single)
from token_guard import assert_tokens_match_guarded
from _torch_threads import one_thread  # noqa: F401

SEED = 0xFA7
CPU = torch.device("cpu")
PRESETS = ("mistral_7b", "qwen2_7b", "qwen3_8b", "phi3_mini",
           "qwen3_moe_a3b")


def _t(a):
    return convert.tensor_from_numpy(a, CPU)


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", PRESETS)
def test_presets_carry_across(preset):
    """config_from_jax of each preset equals the port's own preset, at the
    reference's published widths."""
    jcfg = getattr(JM.LlamaConfig, preset)()
    cfg = convert.config_from_jax(jcfg)
    assert cfg == getattr(TM.LlamaConfig, preset)()
    assert (cfg.head_dim, cfg.rotary_dim, cfg.n_heads // cfg.n_kv_heads) == (
        jcfg.head_dim, jcfg.rotary_dim, jcfg.n_heads // jcfg.n_kv_heads)
    # the reference's (sliding, chunk) pair: no chunk on these presets
    assert [cfg.layer_window(i) for i in (0, cfg.n_layers - 1)] == [
        jcfg.layer_window(i) for i in (0, jcfg.n_layers - 1)]
    assert all(cfg.layer_window(i)[1] is None for i in range(cfg.n_layers))


# The flags of queue 1 item 5 carry across since it was ported, also
# beside the ones ported before (tests/test_torch_llama4_gpt_oss.py holds
# their models); expert parallelism (ep_axis, moe_a2a) still raises, also
# beside a ported flag.
@pytest.mark.parametrize("flags", [
    dict(sliding_window=64, nope_pattern=4), dict(chunk_window=64),
    dict(qk_norm=True, yarn=JM.YarnRope()), dict(qkv_bias=True, o_bias=True),
    dict(moe_bias=True), dict(attn_sinks=True),
    dict(shared_expert_d_ff=64), dict(ep_axis="ep"),
    dict(attn_sinks=True, moe_a2a=True)])
def test_other_family_flags_still_raise(flags):
    jcfg = JM.LlamaConfig.tiny(**flags)
    raising = [f for f in flags if f in ("ep_axis", "moe_a2a")]
    if raising:
        with pytest.raises(NotImplementedError, match=raising[0]):
            convert.config_from_jax(jcfg)
        return
    cfg = convert.config_from_jax(jcfg)
    for f, v in flags.items():
        want = v if f != "yarn" else TM.YarnRope(*dataclasses.astuple(v))
        assert getattr(cfg, f) == want, f


def _family_cfg(**kw):
    """A small head_dim-128 config (the kernels' head_dim) with `kw` on
    top."""
    return JM.LlamaConfig(**{**dict(vocab_size=256, d_model=256, n_layers=2,
                                    n_heads=4, n_kv_heads=2, d_ff=512,
                                    max_seq_len=256, head_dim_override=128),
                             **kw})


def _set_family_leaves(jparams, seed):
    """Non-trivial biases and norm weights from the seed (the inits are
    zeros and ones), so the tests see the bias add and the norm weights."""
    rng = np.random.default_rng(seed)
    for layer in jparams["layers"]:
        for k in ("bq", "bk", "bv"):
            if k in layer:
                layer[k] = jnp.asarray(rng.normal(0, 0.5, layer[k].shape),
                                       layer[k].dtype)
        for k in ("q_norm", "k_norm"):
            if k in layer:
                layer[k] = jnp.asarray(rng.uniform(0.5, 1.5, layer[k].shape),
                                       layer[k].dtype)
    return jparams


def test_family_params_carry_across():
    """init_params, random_quantized_params and quantize_params give the
    reference's tree (biases and norms float, of its shapes and dtypes);
    params_from_jax carries the biases and norms byte for byte."""
    jcfg = _family_cfg(qkv_bias=True, qk_norm=True, n_heads=7, n_kv_heads=1)
    cfg = convert.config_from_jax(jcfg)
    jfloat = JM.init_params(jcfg, jax.random.key(SEED))
    for mine, ref in ((TM.init_params(cfg, 1, device=CPU), jfloat),
                      (TM.random_quantized_params(cfg, 1, lm_head_bits=8,
                                                  device=CPU),
                       JM.random_quantized_params(jcfg, jax.random.key(1),
                                                  lm_head_bits=8))):
        for tl, jl in zip(mine["layers"], ref["layers"]):
            assert sorted(tl) == sorted(jl)
            for k in ("bq", "bk", "bv", "q_norm", "k_norm"):
                assert tuple(tl[k].shape) == jl[k].shape
                np.testing.assert_array_equal(tl[k].float().numpy(),
                                              np.asarray(jl[k], np.float32))
    jq = _set_family_leaves(JM.quantize_params(jfloat, bits=4), SEED)
    tq = TM.quantize_params(convert.params_from_jax(jfloat, device=CPU), 4)
    got = convert.params_from_jax(jq, device=CPU)
    for tl, gl, jl in zip(tq["layers"], got["layers"], jq["layers"]):
        assert sorted(tl) == sorted(jl)
        for k in ("bq", "bk", "bv", "q_norm", "k_norm"):
            assert gl[k].dtype == torch.bfloat16 and not hasattr(tl[k], "bits")
            np.testing.assert_array_equal(
                gl[k].view(torch.int16).numpy(),
                np.asarray(jl[k]).view(np.int16))


def test_partial_rope_matches_jax():
    """Partial rotary at rotary_dim_override = head_dim / 2: the first 48
    dims of each head rotate, the rest pass through, as in JAX."""
    jcfg = JM.LlamaConfig(vocab_size=256, d_model=384, n_layers=1,
                          n_heads=4, n_kv_heads=4, d_ff=512,
                          rotary_dim_override=48)
    cfg = convert.config_from_jax(jcfg)
    assert (cfg.head_dim, cfg.rotary_dim) == (96, 48)
    rng = np.random.default_rng(SEED)
    pos = rng.integers(0, 4000, (2, 9)).astype(np.int32)
    x = rng.normal(0, 1, (2, 4, 9, 96)).astype(np.float32)
    jc, js = JM._rope_freqs(jcfg, jnp.asarray(pos))
    tc, ts = TM._rope_freqs(cfg, _t(pos))
    assert tuple(tc.shape) == (2, 9, 24)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-3)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-3)
    want = np.asarray(JM.apply_rope(jnp.asarray(x), jc, js))
    got = TM.apply_rope(_t(x), _t(np.asarray(jc)), _t(np.asarray(js)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got[..., 48:].numpy(), x[..., 48:])


# ---------------------------------------------------------------------------
# the windowed kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

# Flash output element by element: atol 2e-3, rtol 2e-2 (the causal flash
# bound: bf16 probabilities before the PV product in both, at running
# maxima of another tile order).  Window 1 attends to the diagonal alone
# (out = v); window 256 = T is the plain causal mask.
@pytest.mark.parametrize("rep", [1, 4, 7])
@pytest.mark.parametrize("window", [1, 64, 100, 256])
def test_flash_window_matches_pallas(rep, window):
    b, hkv, t, d = 1, 2, 256, 128
    rng = np.random.default_rng(SEED + rep * window)
    q = rng.normal(0, 1, (b, hkv, rep, t, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, hkv, t, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, hkv, t, d)).astype(np.float32)
    with jax.enable_x64(False), pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), d ** -0.5, window=window,
                                  interpret=True))
    launches = TF.flash_attn.launches
    got = TF.flash_prefill_masked(_t(q), _t(k), _t(v), d ** -0.5,
                                  window=window)
    assert TF.flash_attn.launches == launches          # CPU: plain
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-2)
    direct = TF.flash_attn_plain(_t(q), _t(k), _t(v), d ** -0.5, window)
    assert torch.equal(direct, got)


def test_flash_window_gates():
    """The reference's gates: None for a window < 1, a window with a chunk
    and the geometry gates; the chunk and sinks run, beside a softcap and
    a window too, as their plain version."""
    q = torch.zeros(1, 1, 7, 128, 128)
    k = torch.zeros(1, 1, 128, 128)
    assert TF.flash_prefill_masked(q, k, k, 1.0, window=0) is None
    assert TF.flash_prefill_masked(q, k, k, 1.0, window=8, chunk=64) is None
    assert TF.flash_prefill_masked(q[..., :100, :], k[..., :100, :],
                                   k[..., :100, :], 1.0, window=8) is None
    assert TF.flash_prefill_masked(q, k, k, 1.0, window=8) is not None
    for opt in ({"chunk": 64}, {"chunk": 64, "softcap": 30.0},
                {"window": 8, "sinks": torch.zeros(1, 7)}):
        got = TF.flash_prefill_masked(q, k, k, 1.0, **opt)
        assert torch.equal(got, TF.flash_attn_plain(
            q, k, k, 1.0, opt.get("window"), opt.get("softcap"),
            opt.get("chunk"), None, opt.get("sinks")))


# Decode-attention state over a window of 301 positions, as the model
# computes it (starts = max(pos - 300, 0)), at odd GQA reps: m to f32
# rounding, l within 2e-2, the normalized context of each live row within
# atol 2e-3, rtol 2e-2 (tests/test_torch_kernels.py's bounds); the pos = 0
# row keeps the reference's sentinel exactly.  Odd and even starts put the
# kv4 window's first position on either half of a pair row.
@pytest.mark.parametrize("kv", ["kv8", "kv4"])
@pytest.mark.parametrize("rep", [3, 7])
def test_decode_window_matches_pallas(kv, rep):
    rng = np.random.default_rng(SEED + rep + (kv == "kv4"))
    nl, b, hkv, s, d, w = 2, 4, 1, 1024, 128, 301
    if kv == "kv4":
        cache = _random_kv4(rng, nl, b, hkv, s, d)
    else:
        cache = _stacked_cache(rng, nl, b, hkv, s, d)
    q = rng.normal(0, 1, (b, hkv, rep, d)).astype(np.float32)
    pos = np.array([0, 37, 700, 1023], np.int32)
    starts = np.maximum(pos - (w - 1), 0)
    assert (starts > 0).sum() == 2 and len(set(starts[2:] % 2)) == 2
    wrapper = TDA.decode_attn2_kv4 if kv == "kv4" else TDA.decode_attn2
    for layer in (0, 1):
        with jax.enable_x64(False):
            jst = j_decode_state(
                jnp.asarray(q), *(jnp.asarray(a) for a in cache),
                jnp.asarray(pos), d ** -0.5, layer=layer,
                starts=jnp.asarray(starts), interpret=True)
            acc, m, l = (np.asarray(a) for a in jst)
        launches = wrapper.launches
        tst = TDA.decode_attention_state(
            _t(q), *(_t(a) for a in cache), _t(pos), d ** -0.5, layer=layer,
            starts=_t(starts))
        assert wrapper.launches == launches                # CPU: plain
        tacc, tm, tl = (a.numpy() for a in tst)
        assert (tm[0] == -1e30).all() and (tl[0] == 0).all()
        assert (tacc[0] == 0).all()
        np.testing.assert_allclose(tm, m, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tl, l, rtol=2e-2)
        np.testing.assert_allclose(tacc[1:] / tl[1:], acc[1:] / l[1:],
                                   atol=2e-3, rtol=2e-2)


# ---------------------------------------------------------------------------
# tiny models against JAX
# ---------------------------------------------------------------------------

def _setup(jcfg, seed):
    jparams = _set_family_leaves(
        JM.quantize_params(JM.init_params(jcfg, jax.random.key(seed)),
                           bits=4), seed)
    return (jparams, convert.config_from_jax(jcfg),
            convert.params_from_jax(jparams, device=CPU))


# Each family's tiny model: prefill of a 128-token prompt (the port's flash
# path where head_dim is 128; JAX materializes scores on the CPU) and 3
# decode steps (the port's decode_attn2 plain version with its window
# starts; JAX's masked path), within LOGIT_TOL (tests/test_torch_model.py)
# with its near-tie guard.  The windows of 8 and 64 bite at this length.
FAMILIES = {
    "mistral_w8": dict(sliding_window=8),
    "mistral_w64": dict(sliding_window=64),
    "qwen2_rep7": dict(qkv_bias=True, n_heads=7, n_kv_heads=1),
    "qwen3": dict(qk_norm=True),
    "phi3": dict(d_model=384, n_heads=4, n_kv_heads=4,
                 head_dim_override=None, rotary_dim_override=48),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_logits_match_jax(monkeypatch, family):
    jcfg = _family_cfg(**FAMILIES[family])
    jparams, cfg, params = _setup(jcfg, SEED + len(family))
    rng = np.random.default_rng(SEED)
    toks = jnp.asarray(rng.integers(1, cfg.vocab_size, (2, 128 + 3)),
                       jnp.int32)
    # the window each flash call gets, the starts each decode call gets
    calls = {"flash": [], "decode": []}
    flash, decode = TF.flash_attn_plain, TDA.decode_attn2_plain
    monkeypatch.setattr(TF, "flash_attn_plain", lambda *a: (
        calls["flash"].append(a[4:]), flash(*a))[1])
    monkeypatch.setattr(TDA, "decode_attn2_plain", lambda *a: (
        calls["decode"].append(a[6]), decode(*a))[1])
    got = _run_port(cfg, params, toks, 3)
    _check_logits(got, _run_jax(jcfg, jparams, toks, 3, jit=True))
    if cfg.head_dim % 128:      # head_dim 96: the materialized paths
        assert calls == {"flash": [], "decode": []}
        return
    # (window, softcap, chunk, pos0, sinks)
    assert calls["flash"] == [(cfg.sliding_window, None, None, None,
                               None)] * cfg.n_layers
    assert len(calls["decode"]) == 3 * cfg.n_layers
    w = cfg.sliding_window
    for i, starts in enumerate(calls["decode"][::cfg.n_layers]):
        want = 0 if w is None else max(128 + i - (w - 1), 0)
        assert starts.tolist() == [want, want]


@pytest.mark.heavy_interpret
def test_mistral_logits_match_jax_kernels(monkeypatch):
    """The Mistral-like model with JAX forced onto its own Pallas kernels
    (interpret mode): the native flash kernel's window branch at prefill
    and decode_attn2 with its window starts."""
    monkeypatch.setenv("PIQUANT_ATTN2", "force")
    monkeypatch.setenv("PIQUANT_FLASH", "force")
    monkeypatch.setenv("PIQUANT_FLASH_IMPL", "native")
    jcfg = _family_cfg(sliding_window=64)
    jparams, cfg, params = _setup(jcfg, SEED + 1)
    rng = np.random.default_rng(SEED + 1)
    toks = jnp.asarray(rng.integers(1, cfg.vocab_size, (2, 128 + 3)),
                       jnp.int32)
    with jax.enable_x64(False):
        want = _run_jax(jcfg, jparams, toks, 3, jit=True)
    _check_logits(_run_port(cfg, params, toks, 3), want)


def test_qwen3_moe_logits_match_jax():
    """A tiny qk-norm MoE (tests/test_torch_moe.py's tiny MoE with the
    Qwen3 flag and norm weights from the seed): ragged prefill in the port,
    dense in JAX on the CPU, then 3 dense-masked decode steps."""
    jcfg = JM.LlamaConfig.tiny(n_experts=4, moe_top_k=2, qk_norm=True)
    jparams, cfg, params = _setup(jcfg, SEED + 5)
    rng = np.random.default_rng(SEED + 5)
    toks = jnp.asarray(rng.integers(1, cfg.vocab_size, (2, 48 + 3)),
                       jnp.int32)
    _check_logits(_run_port(cfg, params, toks, 3),
                  _run_jax(jcfg, jparams, toks, 3, jit=True))


def test_engine_window_matches_single_request():
    """The engine under a window of 16 (prompts and generations past it,
    prefills of whole 128-position tiles through flash): greedy tokens
    equal single-request generation under the near-tie guard."""
    jcfg = _family_cfg(sliding_window=16, max_seq_len=128)
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
# the CLI on each preset, patched to a tiny width
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=256, d_model=256, n_layers=2, n_heads=2,
            n_kv_heads=1, d_ff=512, max_seq_len=256)


@pytest.mark.parametrize("preset", PRESETS)
def test_cli_family_presets(monkeypatch, preset):
    """`--random <preset> --device cpu --benchmark 2` with the preset at a
    tiny width keeping its family flags (Mistral's window cut to 32, so it
    bites on the CLI's prompts; Qwen3-MoE's experts to 4): both requests
    complete, random codes with the INT8 lm_head, the flags reach the
    model."""
    full = getattr(TM.LlamaConfig, preset)()
    flags = dict(qkv_bias=full.qkv_bias, qk_norm=full.qk_norm,
                 sliding_window=full.sliding_window and 32,
                 rotary_dim_override=full.rotary_dim_override)
    if preset == "phi3_mini":
        flags.update(d_model=192, n_heads=2, n_kv_heads=2)   # head_dim 96
    if full.n_experts:
        flags.update(n_experts=4, moe_top_k=2, moe_d_ff=256)
    small = dataclasses.replace(full, **{**TINY, **flags})
    monkeypatch.setattr(TM.LlamaConfig, preset, staticmethod(lambda: small))
    args = S.build_parser().parse_args(
        ["--random", preset, "--device", "cpu", "--benchmark", "2",
         "--slots", "2", "--max-new", "4", "--max-seq-len", "256"])
    cfg, params, eng, sp = S.build(args)
    assert dataclasses.replace(cfg, kv_bits=8) == small
    layer = params["layers"][0]
    assert params["lm_head"].bits == 8 and layer["wq"].bits == 4
    assert ("bq" in layer) == full.qkv_bias
    assert ("q_norm" in layer) == full.qk_norm
    assert ("router" in layer) == bool(full.n_experts)
    m, done = S.benchmark(args, cfg, eng, sp)
    assert m["completed"] == 2 and m["decode_tokens"] == 2 * 3
    for r in done:
        assert len(r.tokens) == 4 and all(0 <= t < 256 for t in r.tokens)
        assert all(np.isfinite(lp) and lp <= 0 for lp in r.logprobs)
