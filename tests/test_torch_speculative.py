"""Speculative decoding and requantize_params of the port on the CPU
(piquant_tpu_torch/models/speculative.py, the engine's speculative paths),
held against the JAX package on the same numpy inputs and against the
port's own plain greedy decoding.

The block comparisons run a float32 tiny model, as the reference's own
identity test does, and JAX eagerly (`jax.disable_jit`: under jit XLA keeps
bf16 intermediates in f32), so argmax tokens, emit counts and histories are
compared exactly and log-probs to LP_ATOL."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from piquant_tpu.models import llama as JM
from piquant_tpu.models import speculative as JS
from piquant_tpu.quant import kv_cache as JKV
from piquant_tpu_torch import convert
from piquant_tpu_torch.models import llama as TM
from piquant_tpu_torch.models import speculative as TS
from piquant_tpu_torch.quant import kv_cache as TKV
from piquant_tpu_torch.quant.linear import (QuantizedExpertStack,
                                            QuantizedLinear)
from piquant_tpu_torch.serving import (Engine, EngineConfig, Request,
                                       SamplingParams)
from _torch_threads import one_thread  # noqa: F401

SEED = 0x5BEC
CPU = torch.device("cpu")
G = 4
# emit_lp against eager JAX: both packages attend with bf16 operands over
# an int8 cache and round at other points (tests/test_torch_model.py's
# LOGIT_TOL is 1.5e-2 of the largest logit); measured 1.2e-2 at most here
LP_ATOL = 2e-2
KV4_LP_ATOL = 5e-2       # 2.5 times: the kv4 gap's (measured 2.2e-2)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def f32():
    """The reference identity test's model: tiny, f32, INT8 weights; and
    an INT4 draft of the same checkpoint."""
    jcfg = JM.LlamaConfig.tiny(vocab=64, dtype=jnp.float32)
    fparams = JM.init_params(jcfg, jax.random.key(SEED))
    jparams = JM.quantize_params(fparams, bits=8)
    jdraft = JM.quantize_params(fparams, bits=4)
    return (jcfg, jparams, jdraft, convert.config_from_jax(jcfg),
            convert.params_from_jax(jparams, device=CPU),
            convert.params_from_jax(jdraft, device=CPU))


# ---------------------------------------------------------------------------
# ngram_draft
# ---------------------------------------------------------------------------

def _hist_case(name, rng):
    s = 40
    if name == "random_rows":            # a small vocab: many bigram matches
        hist = rng.integers(0, 4, (5, s))
        pos = rng.integers(0, s, 5)
    elif name == "no_match":
        hist = np.tile(np.arange(s), (2, 1))
        pos = np.array([10, 39])
    elif name == "match_at_last_candidate":
        # the bigram (hist[pos-1], hist[pos]) also ends at pos - 1 only
        hist = np.tile(np.arange(100, 100 + s), (2, 1))
        hist[0, 8:12] = 7
        hist[1, 20:23] = 9
        pos = np.array([11, 22])
    elif name == "pos_0_and_1":
        hist = rng.integers(0, 3, (4, s))
        pos = np.array([0, 1, 0, 1])
    else:                                # the drafts run past the end
        hist = np.tile(np.arange(s) % 3, (3, 1))
        pos = np.array([s - 1, s - 2, 5])
    return hist.astype(np.int32), pos.astype(np.int32)


@pytest.mark.parametrize("case", ["random_rows", "no_match",
                                  "match_at_last_candidate", "pos_0_and_1",
                                  "drafts_past_end"])
def test_ngram_draft_bit_for_bit(case):
    hist, pos = _hist_case(case, np.random.default_rng(SEED + len(case)))
    want = np.asarray(JS.ngram_draft(jnp.asarray(hist), jnp.asarray(pos), G))
    got = TS.ngram_draft(_t(hist), _t(pos), G)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "no_match":
        assert not want.any()


# ---------------------------------------------------------------------------
# the speculative blocks against JAX
# ---------------------------------------------------------------------------

PROMPTS = (([5, 9, 11, 5, 9, 11, 5, 9, 11, 5, 9] * 2)[:20],   # repetitive
           list(np.random.default_rng(3).integers(1, 60, 20)),  # random
           ([7, 7, 8, 8, 7, 7, 8, 8] * 3)[:20])                # periodic
MAX_LEN = 64
ACTIVE = np.array([True, True, False])


def _start(jcfg, jparams, cfg, params, kv_bits=8, prompts=PROMPTS):
    """Both packages' caches after one prefill of the prompts, the first
    tokens, positions and [B, MAX_LEN + G + 2] histories."""
    if kv_bits != 8:
        jcfg = dataclasses.replace(jcfg, kv_bits=kv_bits)
        cfg = dataclasses.replace(cfg, kv_bits=kv_bits)
    rows = np.array(prompts, np.int32)
    b, t = rows.shape
    jc = JM.init_kv_cache(jcfg, b, max_len=MAX_LEN)
    with jax.disable_jit():
        jl, jc = JM.prefill(jcfg, jparams, jnp.asarray(rows), jc)
    tc = TM.init_kv_cache(cfg, b, max_len=MAX_LEN, device=CPU)
    tl, tc = TM.prefill(cfg, params, _t(rows), tc)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(), tok)
    hist = np.zeros((b, MAX_LEN + G + 2), np.int32)
    hist[:, :t] = rows
    hist[:, t] = tok
    pos = np.full((b,), t, np.int32)
    return jcfg, cfg, (jc, tc), tok, pos, hist


def _same_outputs(got, want, n_exact):
    """got (port tensors) against want (JAX arrays): emit_hist exactly,
    emit_lp to LP_ATOL, the next n_exact outputs exactly."""
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=LP_ATOL, rtol=0)
    for g, w in zip(got[2:2 + n_exact], want[2:2 + n_exact]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_spec_block_matches_jax(f32):
    jcfg, jparams, _, cfg, params, _ = f32
    jcfg, cfg, (jc, tc), tok, pos, hist = _start(jcfg, jparams, cfg, params)
    with jax.disable_jit():
        want = JS.spec_block(jcfg, jparams, jnp.asarray(tok),
                             jnp.asarray(pos), jc, jnp.asarray(hist),
                             jnp.asarray(ACTIVE), 3, G)
    got = TS.spec_block(cfg, params, _t(tok), _t(pos), tc, _t(hist),
                        _t(ACTIVE), 3, G)
    # emit_hist, emit_lp, then n_emit, tok, pos and hist exactly
    _same_outputs(got, want, 4)
    n_emit = got[2].numpy()
    assert (n_emit[:, ~ACTIVE] == 0).all()
    assert n_emit.max() > 1, "no draft accepted: the test shows nothing"


# The reference's draft rounds run G draft steps, so when the target
# accepts all G the draft cache never gets the last draft's K/V (position
# pos + G) and every later draft step attends to that hole; the port's
# rounds run one more draft step that writes it (models/speculative.py::
# _draft_round).  The JAX side here is the reference's block one round at a
# time with that step added: JAX's own decode_step on the G-th verified
# token at pos + G (the last draft wherever all G were accepted; elsewhere a
# position the next round writes before it attends to it).
def test_draft_spec_block_matches_jax(f32):
    jcfg, jparams, jdraft, cfg, params, draft = f32
    jcfg, cfg, (jc, tc), tok, pos, _ = _start(jcfg, jparams, cfg, params)
    jdc = JM.init_kv_cache(jcfg, 3, max_len=MAX_LEN)
    tdc = TM.init_kv_cache(cfg, 3, max_len=MAX_LEN, device=CPU)
    rows = np.array(PROMPTS, np.int32)
    jtok, jpos, rounds = jnp.asarray(tok), jnp.asarray(pos), []
    with jax.disable_jit():
        _, jdc = JM.prefill(jcfg, jdraft, jnp.asarray(rows), jdc)
        for _ in range(3):
            emit, lp, n_emit, ntok, npos, jc, jdc = JS.draft_spec_block(
                jcfg, jparams, jcfg, jdraft, jtok, jpos, jc, jdc,
                jnp.asarray(ACTIVE), 1, G)
            _, jdc = JM.decode_step(jcfg, jdraft, emit[0, :, G - 1],
                                    jpos + G, jdc)
            rounds.append((emit, lp, n_emit))
            jtok, jpos = ntok, npos
    want = [np.concatenate([np.asarray(r[i]) for r in rounds])
            for i in range(3)] + [jtok, jpos]
    _, tdc = TM.prefill(cfg, draft, _t(rows), tdc)
    got = TS.draft_spec_block(cfg, params, cfg, draft, _t(tok), _t(pos), tc,
                              tdc, _t(ACTIVE), 3, G)
    _same_outputs(got, want, 3)              # n_emit, tok, pos
    n_emit = got[2].numpy()
    assert n_emit.max() == G + 1 and n_emit[1:, 0].max() > 1, (
        "no round after a full acceptance accepted a draft")


def test_verify_takes_mla_configs(f32):
    """An MLA config verifies through mla.forward_verify (the absorbed
    path over the latent cache), and an MLA draft drafts through
    mla.decode_step: the MLA model as its own draft accepts every
    proposal (tests/test_torch_mla.py holds the MLA blocks against
    JAX)."""
    from piquant_tpu_torch.models import mla as ML

    mcfg = ML.MLAConfig.tiny(vocab=f32[3].vocab_size, dtype=torch.float32)
    mparams = ML.init_params(mcfg, SEED, device=CPU)
    rows = _t(np.array(PROMPTS, np.int32))
    pos = torch.full((3,), 20, dtype=torch.int32)
    toks = torch.tensor([[3, 4, 5]] * 3, dtype=torch.int32)
    positions = pos[:, None] + torch.arange(3, dtype=torch.int32)[None]
    caches = []
    for _ in range(3):
        c = ML.init_kv_cache(mcfg, 3, max_len=MAX_LEN, device=CPU)
        last, _ = ML.prefill(mcfg, mparams, rows, c)
        caches.append(c)
    got, _ = TS._verify_forward(mcfg, mparams, toks, positions, caches[0])
    want, _ = ML.forward_verify(mcfg, mparams, toks, positions, caches[1])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    tok = last.argmax(-1).to(torch.int32)
    dcache = ML.init_kv_cache(mcfg, 3, max_len=MAX_LEN, device=CPU)
    ML.prefill(mcfg, mparams, rows, dcache)
    n_emit = TS.draft_spec_block(mcfg, mparams, mcfg, mparams, tok, pos,
                                 caches[2], dcache, _t(ACTIVE), 2, 2)[2]
    assert n_emit[:, ACTIVE].tolist() == [[3, 3], [3, 3]]
    assert not n_emit[:, ~ACTIVE].any()


# ---------------------------------------------------------------------------
# the kv4 cache under a verify: G + 1 positions a row from odd and even
# starts, then the next verify from the accepted position over the
# rejected tail
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("starts,accepted", [((11, 20), (2, 0)),
                                             ((20, 11), (1, 4)),
                                             ((7, 7), (3, 1))])
def test_kv4_verify_appends_byte_equal(starts, accepted):
    nl, b, h, s, d = 2, 2, 2, 32, 16
    rng = np.random.default_rng(SEED + sum(starts))
    jc = jax.tree.map(lambda a: jnp.stack([a] * nl),
                      JKV.kv_cache_init(b, h, s, d, bits=4))
    one = TKV.kv_cache_init(b, h, s, d, bits=4, device=CPU)
    tc = TKV.KVCache(*(torch.stack([a] * nl) for a in one.tensors()))

    def append(layer, pos):
        k = rng.normal(0, 1, (b, h, pos.shape[1], d)).astype(np.float32)
        v = rng.normal(0, 1, (b, h, pos.shape[1], d)).astype(np.float32)
        nonlocal jc
        jc = JKV.kv_cache_append_stacked(jc, layer, jnp.asarray(k),
                                         jnp.asarray(v), jnp.asarray(pos))
        TKV.kv_cache_append_stacked(tc, layer, _t(k), _t(v), _t(pos))

    for layer in range(nl):          # every pair row holds two positions
        append(layer, np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)))
    pos = np.array(starts, np.int32)
    for _ in range(2):
        at = pos[:, None] + np.arange(G + 1, dtype=np.int32)[None]
        for layer in range(nl):
            append(layer, at)
        pos = pos + np.array(accepted, np.int32) + 1
    for f in ("k_codes", "v_codes", "k_scale", "v_scale", "length"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)


def test_kv4_spec_block_matches_jax(f32):
    """The speculative block over a kv4 cache: the emitted tokens, counts,
    positions and history against JAX.  The argmax at a rejected position
    is never emitted; the kv4 gap between the packages is 2.5 times kv8's
    (tests/test_torch_kv4.py), and one such argmax of this nearly flat
    tiny model (log-probs ~ -3.7 over 64 tokens) lies on a near-tie, so
    the rejected positions are not compared.  The cache's bytes are held
    on equal K/V above (test_kv4_verify_appends_byte_equal): here K and V
    differ in their last bits between the packages."""
    jcfg, jparams, _, cfg, params, _ = f32
    prompts = [p[:19] for p in PROMPTS]      # odd and even verify starts
    jcfg, cfg, (jc, tc), tok, pos, hist = _start(jcfg, jparams, cfg, params,
                                                 kv_bits=4, prompts=prompts)
    with jax.disable_jit():
        want = JS.spec_block(jcfg, jparams, jnp.asarray(tok),
                             jnp.asarray(pos), jc, jnp.asarray(hist),
                             jnp.asarray(ACTIVE), 3, G)
    got = TS.spec_block(cfg, params, _t(tok), _t(pos), tc, _t(hist),
                        _t(ACTIVE), 3, G)
    n_emit = np.asarray(want[2])
    emitted = np.arange(G + 1)[None, None] < n_emit[..., None]
    np.testing.assert_array_equal(got[0].numpy()[emitted],
                                  np.asarray(want[0])[emitted])
    np.testing.assert_allclose(got[1].numpy()[emitted],
                               np.asarray(want[1])[emitted],
                               atol=KV4_LP_ATOL, rtol=0)
    for g, w in zip(got[2:6], want[2:6]):    # n_emit, tok, pos, hist
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[6].length.numpy(),
                                  np.asarray(want[6].length))
    assert n_emit.max() > 1


# ---------------------------------------------------------------------------
# rejection sampling
# ---------------------------------------------------------------------------

def test_rejection_sampling_is_exact_marginal():
    """The reference's Monte-Carlo check: the first emitted token (the
    accepted draft, or the correction) is distributed as p, whatever q."""
    v, g, n = 8, 2, 4096
    rng = np.random.default_rng(0xACC)
    p_row = rng.dirichlet(np.ones(v)).astype(np.float32)
    q_row = rng.dirichlet(np.ones(v) * 0.3).astype(np.float32)
    p = _t(p_row).expand(n, g + 1, v)
    q = _t(q_row).expand(n, g, v)
    gen = torch.Generator().manual_seed(7)
    drafts = torch.multinomial(q.reshape(-1, v), 1, generator=gen).reshape(
        n, g).to(torch.int32)
    n_acc, next_tok = TS.rejection_sample_step(p, q, drafts, gen)
    assert n_acc.dtype == next_tok.dtype == torch.int32
    n_acc, drafts, next_tok = n_acc.numpy(), drafts.numpy(), next_tok.numpy()
    first = np.where(n_acc >= 1, drafts[:, 0], next_tok)
    emp = np.bincount(first, minlength=v) / n
    tv = 0.5 * np.abs(emp - p_row).sum()
    assert tv < 0.04, (tv, emp, p_row)
    assert 0.05 < (n_acc >= 1).mean() < 1.0


# ---------------------------------------------------------------------------
# requantize_params
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe():
    """A tiny MoE model (expert stacks), INT4-g64 with an INT8 lm_head."""
    jcfg = JM.LlamaConfig.tiny(n_experts=4, moe_top_k=2)
    jparams = JM.quantize_params(JM.init_params(jcfg, jax.random.key(SEED)),
                                 bits=4, group_size=64, quantize_lm_head=True)
    return jparams, convert.params_from_jax(jparams, device=CPU)


def _same_weight(got, want, where):
    want = convert.params_from_jax(want, device=CPU)
    assert type(got) is type(want), where
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype, (where, f.name)
            np.testing.assert_array_equal(a.view(torch.uint8).numpy()
                                          if a.dtype == torch.bfloat16
                                          else a.numpy(),
                                          b.view(torch.uint8).numpy()
                                          if b.dtype == torch.bfloat16
                                          else b.numpy(),
                                          err_msg=f"{where}.{f.name}")
        else:
            assert a == b, (where, f.name)


@pytest.mark.parametrize("bits,gs", [(2, None), (4, None), (8, None),
                                     ("nf4", None), (2, 32), (4, 32),
                                     (8, 64), ("nf4", 64)])
def test_requantize_params_matches_jax(moe, bits, gs):
    jparams, params = moe
    want = JM.requantize_params(jparams, bits, group_size=gs)
    got = TM.requantize_params(params, bits, group_size=gs)
    quantized = 0
    for li, (gl, wl) in enumerate(zip(got["layers"], want["layers"])):
        assert gl.keys() == wl.keys()
        for k, v in gl.items():
            if isinstance(v, (QuantizedLinear, QuantizedExpertStack)):
                _same_weight(v, wl[k], f"layers[{li}].{k}")
                quantized += 1
            else:                    # float leaves: the same objects
                assert v is params["layers"][li][k], k
    assert quantized == 2 * 7        # 4 attention + 3 expert stacks a layer
    _same_weight(got["lm_head"], want["lm_head"], "lm_head")
    assert got["embed"] is params["embed"]
    assert got["final_norm"] is params["final_norm"]


def test_requantize_params_fused_layers():
    """Fused projections re-quantize as one weight; fused_tp and the float
    leaves pass through."""
    jcfg = JM.LlamaConfig.tiny(vocab=64)
    jp = JM.fuse_layer_projections(
        JM.quantize_params(JM.init_params(jcfg, jax.random.key(SEED + 1)),
                           bits=8), jcfg)
    tp = convert.params_from_jax(jp, device=CPU)
    want = JM.requantize_params(jp, 2, group_size=32)
    got = TM.requantize_params(tp, 2, group_size=32)
    for gl, wl, tl in zip(got["layers"], want["layers"], tp["layers"]):
        assert gl["fused_tp"] == 1 and gl["attn_norm"] is tl["attn_norm"]
        for k in ("wqkv", "w13", "wo", "w2"):
            _same_weight(gl[k], wl[k], k)
    assert got["lm_head"] is tp["lm_head"]     # float: passes through


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _serve(cfg, params, prompts, n_new, draft=None, sps=None, **ec):
    eng = Engine(cfg, params, EngineConfig(**ec), draft=draft, device=CPU)
    reqs = [Request(rid=i, prompt=list(p), sampling=(
        sps[i] if sps else SamplingParams(max_new_tokens=n_new)))
        for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [list(r.tokens) for r in reqs], eng


def test_speculative_greedy_identical(f32):
    """The reference's test: prompt lookup emits the tokens of plain greedy
    decoding, on repetitive and random prompts."""
    cfg, params = f32[3], f32[4]
    prompts = [PROMPTS[0], list(np.random.default_rng(3).integers(1, 60, 17)),
               ([7, 7, 8, 8, 7, 7, 8, 8] * 3)[:21]]
    kw = dict(batch_slots=2, max_seq_len=128, decode_block=3)
    base, _ = _serve(cfg, params, prompts, 24, **kw)
    spec, eng = _serve(cfg, params, prompts, 24, speculate=4, **kw)
    assert [len(t) for t in base] == [24, 24, 24]
    assert spec == base
    assert eng.metrics.decode_tokens == 3 * 23


@pytest.fixture(scope="module")
def bf16():
    """The reference draft tests' model: tiny, bf16, INT8 target and an
    INT4 draft of the same checkpoint."""
    cfg = TM.LlamaConfig.tiny(vocab=64)
    fparams = TM.init_params(cfg, SEED, device=CPU)
    return (cfg, TM.quantize_params(fparams, bits=8),
            TM.quantize_params(fparams, bits=4))


def test_draft_spec_greedy_identity(bf16):
    cfg, params, draft4 = bf16
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 60, n).tolist() for n in (9, 5)]
    kw = dict(batch_slots=2, max_seq_len=128, decode_block=4)
    want, _ = _serve(cfg, params, prompts, 12, **kw)
    got, _ = _serve(cfg, params, prompts, 12, draft=(cfg, draft4),
                    speculate=3, **kw)
    assert got == want
    # a requantize_params draft (INT2) serves the same tokens
    got2, _ = _serve(cfg, params, prompts, 12,
                     draft=(cfg, TM.requantize_params(params, 2)),
                     speculate=3, **kw)
    assert got2 == want


def test_perfect_draft_accepts_everything(bf16, monkeypatch):
    """Draft == target: every proposal verifies, so each verify step emits
    G + 1 tokens (the last one of a request may be cut by max_new)."""
    cfg, params, _ = bf16
    counts = []
    real = TS.draft_spec_block

    def spy(*a, **kw):
        out = real(*a, **kw)
        counts.append(out[2])
        return out

    monkeypatch.setattr(TS, "draft_spec_block", spy)
    want, _ = _serve(cfg, params, [[5, 6]], 12, batch_slots=1,
                     max_seq_len=128, decode_block=4)
    got, eng = _serve(cfg, params, [[5, 6]], 12, draft=(cfg, params),
                      speculate=3, batch_slots=1, max_seq_len=128,
                      decode_block=4)
    assert got == want
    assert eng.metrics.decode_tokens == 12 - 1
    n_emit = torch.cat(counts).flatten().tolist()
    assert n_emit[:2] == [4, 4], n_emit      # 1 + 4 + 4 + (cut) 3 tokens


@pytest.mark.parametrize("case", ["no_speculate", "prefill_chunk",
                                  "prefix_cache", "vocab", "mla_draft"])
def test_draft_validations(bf16, case):
    cfg, params, draft4 = bf16
    ec = dict(batch_slots=1, max_seq_len=64, speculate=2)
    dcfg = cfg
    err, match = ValueError, None
    if case == "mla_draft":
        # an MLA draft of the target's vocab passes the checks and serves
        # the target's greedy tokens
        from piquant_tpu_torch.models import mla as ML

        mcfg = ML.MLAConfig.tiny(vocab=cfg.vocab_size)
        mdraft = ML.quantize_params(ML.init_params(mcfg, SEED, device=CPU),
                                    bits=4)
        want, _ = _serve(cfg, params, [[5, 6, 7]], 8, batch_slots=1,
                         max_seq_len=64)
        got, eng = _serve(cfg, params, [[5, 6, 7]], 8, draft=(mcfg, mdraft),
                          speculate=2, batch_slots=1, max_seq_len=64)
        assert isinstance(eng._dcache, ML.LatentKVCache)
        assert got == want
        return
    if case == "no_speculate":
        ec["speculate"], match = 0, "speculate"
    elif case in ("prefill_chunk", "prefix_cache"):
        ec["prefill_chunk"], match = 8, "one-shot"
        if case == "prefix_cache":
            ec["prefix_cache"] = 2
    else:
        dcfg, match = dataclasses.replace(cfg, vocab_size=32), "vocab"
    with pytest.raises(err, match=match):
        Engine(cfg, params, EngineConfig(**ec), draft=(dcfg, draft4),
               device=CPU)


def test_draft_spec_snapshot_restore(bf16):
    cfg, params, draft4 = bf16
    ec = EngineConfig(batch_slots=1, max_seq_len=128, decode_block=2,
                      speculate=2)

    def fresh():
        return Engine(cfg, params, ec, draft=(cfg, draft4), rng_seed=3,
                      device=CPU)

    eng = fresh()
    r = Request(rid=0, prompt=[4, 5, 6],
                sampling=SamplingParams(max_new_tokens=14))
    eng.submit(r)
    eng._admit()
    eng._step_decode()
    snap = eng.snapshot()
    assert "dcache" in snap and "hist" in snap
    eng.run()
    eng2 = fresh()
    eng2.restore(snap)
    r2 = eng2._all[0]
    eng2.run()
    assert r2.tokens == r.tokens and len(r.tokens) == 14


def test_stochastic_draft_spec_is_deterministic_and_falls_back(bf16):
    cfg, params, draft4 = bf16
    prompts = [np.random.default_rng(2).integers(1, 60, 6).tolist()]
    sp = SamplingParams(temperature=0.9, max_new_tokens=10)
    kw = dict(batch_slots=1, max_seq_len=128, decode_block=3, speculate=2)

    def run():
        eng = Engine(cfg, params, EngineConfig(**kw), draft=(cfg, draft4),
                     rng_seed=11, device=CPU)
        r = Request(rid=0, prompt=list(prompts[0]), sampling=sp)
        eng.submit(r)
        eng._admit()
        assert eng._spec_mode() == "sample"
        eng.run()
        return r

    a, b = run(), run()
    assert a.tokens == b.tokens and len(a.tokens) == 10
    assert all(0 <= t < 64 for t in a.tokens)
    assert all(np.isfinite(lp) and lp <= 0 for lp in a.logprobs)
    # truncation samplers and penalized slots take the plain decode path
    for trunc in (dict(top_k=5), dict(top_p=0.9), dict(min_p=0.1)):
        eng = Engine(cfg, params, EngineConfig(**kw), draft=(cfg, draft4),
                     device=CPU)
        eng.submit(Request(rid=1, prompt=[1, 2], sampling=SamplingParams(
            temperature=0.9, max_new_tokens=6, **trunc)))
        eng._admit()
        assert eng._spec_mode() is None
        assert len(eng.run()[0].tokens) == 6
    eng = Engine(cfg, params, EngineConfig(track_history=True, **kw),
                 device=CPU)
    eng.submit(Request(rid=2, prompt=[1, 2], sampling=SamplingParams(
        repetition_penalty=1.2, max_new_tokens=6)))
    eng._admit()
    assert eng._spec_mode() is None
    assert len(eng.run()[0].tokens) == 6


def test_plain_blocks_keep_the_history_current(bf16):
    """With speculate > 0 and no draft, a sampled slot decodes on the plain
    path and its history stays current: prompt + every emitted token."""
    cfg, params, _ = bf16
    prompt = [3, 4, 5, 6, 7]
    eng = Engine(cfg, params, EngineConfig(batch_slots=1, max_seq_len=64,
                                           decode_block=3, speculate=2),
                 device=CPU)
    r = Request(rid=0, prompt=prompt, sampling=SamplingParams(
        temperature=0.8, max_new_tokens=8))
    eng.submit(r)
    eng.run()
    n = len(prompt) + len(r.tokens)
    assert eng._hist[0, :n].tolist() == prompt + r.tokens


def test_logprobs_match_reference(f32):
    """The reference's log-prob test on the port: plain, speculative and
    history-tracking runs report the log-softmax of single-request decode's
    logits at the greedy tokens, within 5e-3."""
    cfg, params = f32[3], f32[4]
    prompt, n_new = [5, 9, 2, 4, 9, 2], 8
    cache = TM.init_kv_cache(cfg, 1, max_len=128, device=CPU)
    logits, cache = TM.prefill(cfg, params, _t([prompt]).int(), cache)
    want, pos = [], len(prompt)
    for _ in range(n_new):
        tok = int(logits.argmax(-1)[0])
        want.append(float(torch.log_softmax(logits[0].double(), -1)[tok]))
        logits, cache = TM.decode_step(cfg, params,
                                       torch.tensor([tok], dtype=torch.int32),
                                       torch.tensor([pos], dtype=torch.int32),
                                       cache)
        pos += 1
    for ekw in ({}, dict(speculate=3), dict(track_history=True)):
        _, eng = _serve(cfg, params, [prompt], n_new, batch_slots=1,
                        max_seq_len=128, decode_block=3, **ekw)
        r = eng._all[0]
        assert len(r.logprobs) == len(r.tokens) == n_new
        np.testing.assert_allclose(r.logprobs, want, atol=5e-3)
