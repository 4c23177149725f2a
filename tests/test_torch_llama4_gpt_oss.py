"""Llama-4 and GPT-OSS in the port against the JAX package on the CPU: the
two presets and their flags carried across, the flash plain version's
chunk and sinks branches against the Pallas kernel in interpret mode,
YaRN, temperature tuning, the L2 qk-norm, the three MoE forms (Llama-4's
input-scaled sigmoid routing with its ungated shared expert, GPT-OSS's
biased and clamped experts, Qwen2-MoE's gated shared expert), tiny
Llama-4-like and GPT-OSS-like models against eager JAX, the engine against
single-request generation, and the CLI on both presets patched to a tiny
width.  Every sink, bias and router bias is drawn nonzero from the seed
(the inits are zeros), so a missing add shows."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from piquant_tpu.models import llama as JM
from piquant_tpu.ops.pallas.flash import flash_prefill_masked as j_flash
from piquant_tpu_torch import convert
from piquant_tpu_torch.models import llama as TM
from piquant_tpu_torch.ops.cuda import decode_attn2 as TDA
from piquant_tpu_torch.ops.cuda import flash as TF
from piquant_tpu_torch.serving import __main__ as S
from test_torch_model import _run_jax, _run_port
from test_torch_serving import (_engine_tokens, _port_forward, _prompts,
                                _single)
from token_guard import assert_tokens_match_guarded

SEED = 0x14A4
CPU = torch.device("cpu")
PRESETS = ("llama4_scout", "gpt_oss_20b")


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


# Tiny configs at the kernels' head_dim 128.  Llama-4-like: 4 layers (the
# 4th without rope), a chunk of 64 that bites at T = 128, temperature
# tuning from position 15 on (floor_scale 16), 4 experts top 1 with an
# ungated shared expert.  GPT-OSS-like: sinks, biases, alternating windows
# of 32 and full layers, YaRN, 4 experts top 2, biased and clamped.
L4 = dict(n_layers=4, n_experts=4, moe_top_k=1, moe_d_ff=256,
          shared_expert_d_ff=256, shared_expert_gated=False, moe_every=1,
          moe_input_scaled=True, qk_l2norm=True, nope_pattern=4,
          attn_temp_tuning=True, floor_scale=16.0, chunk_window=64,
          rope_interleaved=True, llama3_rope=JM.Llama3Rope(factor=8.0))
OSS = dict(qkv_bias=True, o_bias=True, attn_sinks=True, sliding_window=32,
           sliding_pattern=2, n_experts=4, moe_top_k=2, moe_d_ff=256,
           router_bias=True, moe_bias=True, moe_clamp_swiglu=True,
           yarn=JM.YarnRope(factor=32.0, original_max_position_embeddings=64,
                            truncate=False))


def _cfg(family, **kw):
    return JM.LlamaConfig(**{**dict(vocab_size=256, d_model=256, n_layers=2,
                                    n_heads=4, n_kv_heads=2, d_ff=512,
                                    max_seq_len=256, head_dim_override=128),
                             **family, **kw})


def _set_leaves(jparams, seed):
    """Sinks, biases and router biases from the seed: sinks N(0, 1) with
    the first query head's lifted by 3, so the sink dominates some rows;
    the up and gate biases N(0, 4), so the SwiGLU clamp at 7 bites."""
    rng = np.random.default_rng(seed)
    scales = {"bq": 0.5, "bk": 0.5, "bv": 0.5, "bo": 0.5, "router_b": 1.0,
              "moe_b1": 4.0, "moe_b3": 4.0, "moe_b2": 0.5}
    for layer in jparams["layers"]:
        for k, sd in scales.items():
            if k in layer:
                layer[k] = jnp.asarray(rng.normal(0, sd, layer[k].shape),
                                       layer[k].dtype)
        if "sinks" in layer:
            s = rng.normal(0, 1, layer["sinks"].shape)
            s[0] += 3.0
            layer["sinks"] = jnp.asarray(s, jnp.float32)
    return jparams


def _setup(jcfg, seed, qk_scale=1.0):
    """The reference's init quantized to INT4 (wq and wk times qk_scale
    first), the family leaves from the seed; the config and params carried
    across."""
    jfloat = JM.init_params(jcfg, jax.random.key(seed))
    for layer in jfloat["layers"]:
        for k in ("wq", "wk"):
            layer[k] = (layer[k].astype(jnp.float32) * qk_scale).astype(
                layer[k].dtype)
    jparams = _set_leaves(JM.quantize_params(jfloat, bits=4), seed)
    return (jparams, convert.config_from_jax(jcfg),
            convert.params_from_jax(jparams, device=CPU))


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", PRESETS)
def test_presets_carry_across(preset):
    """config_from_jax of each preset equals the port's own preset at the
    reference's published widths; every layer's (window, chunk) pair,
    locality and rope agree with the reference's."""
    jcfg = getattr(JM.LlamaConfig, preset)()
    cfg = convert.config_from_jax(jcfg)
    assert cfg == getattr(TM.LlamaConfig, preset)()
    layers = range(cfg.n_layers)
    for f in ("layer_window", "layer_is_local", "layer_uses_rope",
              "moe_layer"):
        assert [getattr(cfg, f)(i) for i in layers] == [
            getattr(jcfg, f)(i) for i in layers], f
    if preset == "llama4_scout":
        assert [cfg.layer_window(i) for i in (0, 3)] == [(None, 8192),
                                                         (None, None)]
        assert sum(cfg.layer_uses_rope(i) for i in layers) == 36
    else:
        assert [cfg.layer_window(i) for i in (0, 1)] == [(128, None),
                                                         (None, None)]


@pytest.mark.parametrize("family", ["llama4", "gpt_oss"])
def test_params_carry_across(family):
    """init_params and random_quantized_params give the reference's tree
    (the new leaves of its shapes and dtypes, float or quantized as there);
    quantize_params quantizes the shared expert as the reference does;
    params_from_jax carries the sinks and biases byte for byte."""
    jcfg = _cfg(L4 if family == "llama4" else OSS)
    cfg = convert.config_from_jax(jcfg)
    jfloat = JM.init_params(jcfg, jax.random.key(SEED))
    for mine, ref in ((TM.init_params(cfg, 1, device=CPU), jfloat),
                      (TM.random_quantized_params(cfg, 1, lm_head_bits=8,
                                                  device=CPU),
                       JM.random_quantized_params(jcfg, jax.random.key(1),
                                                  lm_head_bits=8))):
        for tl, jl in zip(mine["layers"], ref["layers"]):
            assert sorted(tl) == sorted(jl)
            for k in tl:
                a, b = tl[k], jl[k]
                assert hasattr(a, "bits") == hasattr(b, "bits"), k
                if not hasattr(a, "bits"):
                    assert tuple(a.shape) == b.shape, k
                    assert str(a.dtype).split(".")[-1] == str(b.dtype), k
    jq = _set_leaves(JM.quantize_params(jfloat, bits=4), SEED)
    tq = TM.quantize_params(convert.params_from_jax(jfloat, device=CPU), 4)
    got = convert.params_from_jax(jq, device=CPU)
    new = ("sinks", "bo", "router_b", "moe_b1", "moe_b3", "moe_b2",
           "shared_gate")
    for tl, gl, jl in zip(tq["layers"], got["layers"], jq["layers"]):
        assert sorted(tl) == sorted(jl)
        for k in ("shared_w1", "shared_w3", "shared_w2"):
            if k in jl:
                assert tl[k].bits == jl[k].bits == 4
                np.testing.assert_array_equal(tl[k].data.numpy(),
                                              np.asarray(jl[k].data))
        for k in (k for k in new if k in jl):
            assert not hasattr(gl[k], "bits")
            np.testing.assert_array_equal(gl[k].float().numpy(),
                                          np.asarray(jl[k], np.float32))
            if k != "shared_gate":
                assert bool(gl[k].float().abs().min() > 0), k


# ---------------------------------------------------------------------------
# flash: the chunk and sinks branches of the plain version against the
# Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

# the reference's cases (tests/test_flash_masked.py), and a chunk boundary
# inside a 128-row tile and inside one 16-row warp of the CUDA kernel
# (pos0 40 and 100: the boundary of chunk 96 at rows 56 and 92)
FLASH_CASES = {
    "chunked": dict(chunk=64),
    "chunked_pos0": dict(chunk=96, pos0=[0, 40]),
    "sinks": dict(sinks=True),
    "gpt_oss": dict(window=64, sinks=True),
    "straddle": dict(chunk=96, pos0=[100, 40], sinks=True, softcap=30.0),
}


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_chunk_sinks_match_pallas(name):
    """atol 2e-3, rtol 2e-2 (tests/test_torch_kernels.py's flash bound);
    the plain version counts no launch on the CPU, and the sinks move the
    context beyond the bound."""
    b, hkv, rep, t, d = 2, 2, 4, 256, 128
    kw = dict(FLASH_CASES[name])
    rng = np.random.default_rng(SEED + len(name))
    q = rng.normal(0, 1, (b, hkv, rep, t, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, hkv, t, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, hkv, t, d)).astype(np.float32)
    jkw, tkw = {}, {}
    if kw.pop("sinks", False):
        s = rng.normal(0, 1, (hkv, rep)).astype(np.float32)
        s[:, 0] += 3.0
        jkw["sinks"], tkw["sinks"] = jnp.asarray(s), _t(s)
    if "pos0" in kw:
        p0 = np.array(kw.pop("pos0"), np.int32)
        jkw["pos0"], tkw["pos0"] = jnp.asarray(p0), _t(p0)
    sm = d ** -0.5
    with jax.enable_x64(False), pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), sm, interpret=True,
                                  **kw, **jkw))
    launches = TF.flash_attn.launches
    got = TF.flash_prefill_masked(_t(q), _t(k), _t(v), sm, **kw, **tkw)
    assert TF.flash_attn.launches == launches          # CPU: plain
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-2)
    if "sinks" in tkw:
        bare = {kk: vv for kk, vv in tkw.items() if kk != "sinks"}
        moved = np.abs(TF.flash_prefill_masked(_t(q), _t(k), _t(v), sm, **kw,
                                               **bare).numpy() - want)
        assert (moved > 2e-3 + 2e-2 * np.abs(want)).any()


def test_flash_chunk_pos0_moves_the_mask():
    """Under a chunk, pos0 moves the boundary: pos0 0 and 32 at chunk 64
    give other contexts on rows 32-63; without a chunk pos0 is not read."""
    rng = np.random.default_rng(SEED + 9)
    q = _t(rng.normal(0, 1, (1, 1, 2, 128, 128)).astype(np.float32))
    k = _t(rng.normal(0, 1, (1, 1, 128, 128)).astype(np.float32))
    a = TF.flash_prefill_masked(q, k, k, 0.1, chunk=64,
                                pos0=torch.tensor([0], dtype=torch.int32))
    b = TF.flash_prefill_masked(q, k, k, 0.1, chunk=64,
                                pos0=torch.tensor([32], dtype=torch.int32))
    assert torch.equal(a[..., :32, :], b[..., :32, :])
    assert not torch.allclose(a[..., 32:64, :], b[..., 32:64, :])
    assert torch.equal(
        TF.flash_prefill_masked(q, k, k, 0.1),
        TF.flash_prefill_masked(q, k, k, 0.1,
                                pos0=torch.tensor([32], dtype=torch.int32)))


# ---------------------------------------------------------------------------
# rope, temperature tuning, the L2 qk-norm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("truncate,af", [(False, None), (True, None),
                                         (True, 1.5)])
def test_yarn_matches_jax(truncate, af):
    """YaRN's inverse frequencies and attention factor (0.1 ln(32) + 1 by
    default) against the reference's, and the cos / sin they give."""
    jcfg = _cfg(OSS, yarn=JM.YarnRope(
        factor=32.0, original_max_position_embeddings=64, truncate=truncate,
        attention_factor=af))
    cfg = convert.config_from_jax(jcfg)
    jinv, jaf = JM._yarn_inv_freq(jcfg)
    inv, taf = TM._yarn_inv_freq(cfg, CPU)
    assert taf == jaf == (af or 0.1 * np.log(32.0) + 1.0)
    np.testing.assert_allclose(inv.numpy(), np.asarray(jinv), rtol=1e-6)
    pos = np.arange(300, dtype=np.int32).reshape(2, 150)
    jc, js = JM._rope_freqs(jcfg, jnp.asarray(pos))
    tc, ts = TM._rope_freqs(cfg, _t(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-5)
    assert abs(float(tc[0, 0, 0]) - taf) < 1e-6     # cos(0) * factor


def _attention_pair(jcfg, seed, layer_idx, pos0=0, t=64):
    """One layer's in-layer attention (no cache, the materialized path
    over the layer's own mask) in both packages on the same x and
    positions pos0 ..  pos0 + t - 1; wq and wk 4x the init, so the scores
    spread and a temperature moves the softmax."""
    jparams, cfg, params = _setup(jcfg, seed, qk_scale=4.0)
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (2, t, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(pos0, pos0 + t, dtype=np.int32), (2, t))
    win, chunk = jcfg.layer_window(layer_idx)
    qp, kp = pos[:, :, None], pos[:, None, :]
    ok = kp <= qp
    if chunk is not None:
        ok = ok & (kp // chunk == qp // chunk)
    mask = np.where(ok, 0.0, -1e9).astype(np.float32)[:, None]
    xj = jnp.asarray(x, jnp.bfloat16)
    want, _ = JM._attention(jcfg, jparams["layers"][layer_idx], xj,
                            jnp.asarray(pos), None, layer_idx,
                            jnp.asarray(mask))
    xt = _t(np.asarray(xj))
    rope = TM._rope_freqs(cfg, _t(pos))
    got = TM._attention(cfg, params["layers"][layer_idx], xt, _t(pos), rope,
                        None, layer_idx, _t(mask), False, None, None, False)
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("layer_idx,l2", [(0, True), (3, True), (0, False)])
def test_temperature_and_l2_norm_match_jax(layer_idx, l2):
    """Layer 0 (rope, chunk 64) and layer 3 (no rope, full, temperature
    tuning) of the Llama-4-like config at positions 100-163, where
    floor_scale 16 lifts q by up to 1.23x: each layer's output within
    1e-2 of the largest (bf16 activations); the L2 norm runs on the rope
    layer only (switching it off moves layer 0 and leaves layer 3 as it
    is), and the temperature moves layer 3."""
    jcfg = _cfg(L4, qk_l2norm=l2)
    got, want = _attention_pair(jcfg, SEED + 3, layer_idx, pos0=100)
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    other, _ = _attention_pair(_cfg(L4, qk_l2norm=not l2), SEED + 3,
                               layer_idx, pos0=100)
    assert np.array_equal(other, got) == (layer_idx == 3)
    if layer_idx == 3:
        cold, _ = _attention_pair(_cfg(L4, qk_l2norm=l2,
                                       attn_temp_tuning=False),
                                  SEED + 3, layer_idx, pos0=100)
        assert not np.allclose(cold, got, atol=1e-2)


# ---------------------------------------------------------------------------
# the MoE forms
# ---------------------------------------------------------------------------

MOE_FORMS = {
    "llama4": L4,
    "gpt_oss": OSS,
    "qwen2_moe_shared": dict(n_experts=4, moe_top_k=2, moe_d_ff=256,
                             shared_expert_d_ff=384, moe_renormalize=False),
}


@pytest.mark.parametrize("t", [4, 48])
@pytest.mark.parametrize("form", list(MOE_FORMS))
def test_moe_forms_match_jax(form, t):
    """_mlp_moe against the reference's on the same x at decode (4 tokens)
    and prefill size (48; the ragged route declines all three forms' flags
    in both but the Qwen2-MoE one, which takes it in the port and the
    dense route in JAX on the CPU): within 2e-2 of the largest (bf16 expert
    outputs in another order).  GPT-OSS's gate and up pre-activations pass
    the +-7 clamp."""
    jcfg = _cfg(MOE_FORMS[form])
    jparams, cfg, params = _setup(jcfg, SEED + 4)
    if form == "qwen2_moe_shared":      # the gate from the seed, not zero
        rng = np.random.default_rng(SEED + 5)
        for jl, tl in zip(jparams["layers"], params["layers"]):
            g = rng.normal(0, 0.5, jl["shared_gate"].shape)
            jl["shared_gate"] = jnp.asarray(g, jnp.bfloat16)
            tl["shared_gate"] = _t(np.asarray(jl["shared_gate"]))
    rng = np.random.default_rng(SEED + t)
    x = jnp.asarray(rng.normal(0, 1, (1, t, cfg.d_model)), jnp.bfloat16)
    want = np.asarray(JM._mlp_moe(jcfg, jparams["layers"][0], x), np.float32)
    got = TM._mlp_moe(cfg, params["layers"][0], _t(np.asarray(x)))
    got = got.float().numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    if form == "gpt_oss":
        layer = params["layers"][0]
        xt = _t(np.asarray(x))
        for w, bias, lim in (("moe_w1", "moe_b1", 7.0),
                             ("moe_w3", "moe_b3", -7.0)):
            pre = torch.stack([
                TM._mm(xt, TM._expert_weight(layer[w], e), torch.bfloat16)
                .float() + layer[bias][e] for e in range(cfg.n_experts)])
            assert bool((pre > 7.0).any()) and bool((pre < -7.0).any()), w
    if form == "llama4":                # top-1 sigmoid scores the input
        assert cfg.moe_top_k == 1 and not cfg.shared_expert_gated


# ---------------------------------------------------------------------------
# tiny models against eager JAX, the engine
# ---------------------------------------------------------------------------

MODELS = {
    "llama4": dict(L4, dtype=jnp.float32),
    "llama4_bf16_top2": dict(L4, moe_top_k=2),
    "gpt_oss": OSS,
    "gpt_oss_d64": dict(OSS, head_dim_override=64),
}


# Prefill of a 128-token prompt (the port's flash plain version with the
# chunk, or the window and sinks; at head_dim 64 the materialized path;
# JAX materializes scores on the CPU) and 3 decode steps (the port's
# decode_attn2 plain version with chunk starts of 128 on the rope layers,
# or the window's starts, and the sinks folded after it; at head_dim 64
# the materialized split softmax) within TOL of the largest logit, the
# argmax differing only at a near tie (tests/test_torch_model.py).  JAX
# runs eagerly (the jax.jit bf16 trap: tests/test_torch_gemma.py).
# TOL: LOGIT_TOL's 1.5e-2 for the 2-layer GPT-OSS-like models; 2.5e-2 for
# the 4-layer Llama-4-like ones, whose L2-normed q and k give peaked
# scores (this seed, f32: a plain 4-layer Llama of the same width lies
# 1.4e-2 from JAX, the Llama-4 flags 1.8e-2; the port's kernel paths lie
# 7.2e-3 from its own materialized ones).  Llama-4's top-1 routing is
# discontinuous: in bf16 the two packages' roundings flip a near-tied
# token's expert and move its logits by 3.7e-2, so the top-1 model runs in
# f32 (the attention products take bf16 operands in both packages still),
# and a top-2 one in bf16 (1.1e-2).
TOL = {"llama4": 2.5e-2, "llama4_bf16_top2": 2.5e-2, "gpt_oss": 1.5e-2,
       "gpt_oss_d64": 1.5e-2}


def _check_logits(got, want, tol):
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err
    top2 = np.sort(want, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > 0.02
    assert (got.argmax(-1) == want.argmax(-1))[decisive].all()
@pytest.mark.parametrize("model", list(MODELS))
def test_tiny_models_match_jax(monkeypatch, model):
    jcfg = _cfg(MODELS[model])
    jparams, cfg, params = _setup(jcfg, SEED + len(model))
    rng = np.random.default_rng(SEED + len(model))
    toks = jnp.asarray(rng.integers(1, cfg.vocab_size, (2, 128 + 3)),
                       jnp.int32)
    calls = {"flash": [], "decode": []}
    flash, decode = TF.flash_attn_plain, TDA.decode_attn2_plain
    monkeypatch.setattr(TF, "flash_attn_plain", lambda *a: (
        calls["flash"].append(a[4:]), flash(*a))[1])
    monkeypatch.setattr(TDA, "decode_attn2_plain", lambda *a: (
        calls["decode"].append(a[6].tolist()), decode(*a))[1])
    got = _run_port(cfg, params, toks, 3)
    _check_logits(got, _run_jax(jcfg, jparams, toks, 3), TOL[model])
    nl = cfg.n_layers
    if cfg.head_dim == 64:              # GPT-OSS's own head_dim: no kernel
        assert calls == {"flash": [], "decode": []}
        return
    assert len(calls["flash"]) == nl and len(calls["decode"]) == 3 * nl
    for i, (win, cap, chunk, pos0, sinks) in enumerate(calls["flash"]):
        assert (win, cap, chunk) == (*cfg.layer_window(i)[:1], None,
                                     cfg.layer_window(i)[1])
        assert (pos0 is not None) == (chunk is not None)
        assert (sinks is not None) == cfg.attn_sinks
    for j, starts in enumerate(calls["decode"]):
        win, chunk = cfg.layer_window(j % nl)
        pos = 128 + j // nl
        want = (pos // chunk * chunk if chunk else
                max(pos - (win - 1), 0) if win else 0)
        assert starts == [want, want]


@pytest.mark.parametrize("model", ["llama4", "gpt_oss"])
def test_engine_matches_single_request(model):
    """The engine on the tiny models (prompts of 100-120 tokens past the
    chunk of 64 or the window of 32; prefills of whole 128-position tiles
    through flash): greedy tokens equal single-request generation under
    the near-tie guard."""
    jcfg = _cfg(MODELS[model], max_seq_len=128)
    _, cfg, params = _setup(jcfg, SEED + 7)
    prompts = _prompts(3, 100, 120, cfg.vocab_size, SEED + 7)
    _, done = _engine_tokens(cfg, params, prompts, 6, batch_slots=2,
                             max_seq_len=128, prefill_pad=128)
    fwd = _port_forward(cfg, params)
    for p, req in zip(prompts, done):
        assert_tokens_match_guarded(fwd, p, req.tokens,
                                    _single(cfg, params, p, 6),
                                    tag=f"rid {req.rid}")


# ---------------------------------------------------------------------------
# the CLI on both presets, patched to a tiny width and depth
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=256, d_model=256, n_heads=4, n_kv_heads=2,
            head_dim_override=128, d_ff=512, max_seq_len=256, n_experts=4,
            moe_d_ff=256)


@pytest.mark.parametrize("preset", PRESETS)
def test_cli_presets(monkeypatch, preset):
    """`--random <preset> --device cpu --benchmark 2` with the preset at a
    tiny width and depth keeping its flags (Llama-4: 4 layers, one without
    rope, a chunk of 64; GPT-OSS: 2 layers, a window of 32; both bite on
    the CLI's prompts), as chip_smoke.py's cut_depth patches a preset:
    both requests complete, from random codes with the INT8 lm_head, and
    the family leaves reach the model."""
    full = getattr(TM.LlamaConfig, preset)()
    flags = (dict(n_layers=4, chunk_window=64, shared_expert_d_ff=256)
             if preset == "llama4_scout" else
             dict(n_layers=2, sliding_window=32))
    small = dataclasses.replace(full, **{**TINY, **flags})
    monkeypatch.setattr(TM.LlamaConfig, preset, staticmethod(lambda: small))
    args = S.build_parser().parse_args(
        ["--random", preset, "--device", "cpu", "--benchmark", "2",
         "--slots", "2", "--max-new", "4", "--max-seq-len", "256"])
    cfg, params, eng, sp = S.build(args)
    assert dataclasses.replace(cfg, kv_bits=8) == small
    layer = params["layers"][0]
    assert params["lm_head"].bits == 8 and layer["moe_w1"].bits == 4
    assert ("shared_w1" in layer) == (preset == "llama4_scout")
    assert ("sinks" in layer and "bo" in layer and "moe_b1" in layer) == (
        preset == "gpt_oss_20b")
    m, done = S.benchmark(args, cfg, eng, sp)
    assert m["completed"] == 2 and m["decode_tokens"] == 2 * 3
    for r in done:
        assert len(r.tokens) == 4 and all(0 <= t < 256 for t in r.tokens)
        assert all(np.isfinite(lp) and lp <= 0 for lp in r.logprobs)
