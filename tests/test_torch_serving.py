"""The port's serving engine and sampler on the CPU, against the port's own
single-request generation and against the JAX package's Engine / sampler."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from piquant_tpu.models import llama as JM
from piquant_tpu.serving import Engine as JEngine
from piquant_tpu.serving import EngineConfig as JEngineConfig
from piquant_tpu.serving import Request as JRequest
from piquant_tpu.serving import SamplingParams as JSamplingParams
from piquant_tpu.serving.sampler import sample_batch as j_sample_batch
from piquant_tpu_torch import convert
from piquant_tpu_torch.models import llama as TM
from piquant_tpu_torch.serving import (Engine, EngineConfig, Request,
                                       SamplingParams, sample)
from piquant_tpu_torch.serving.sampler import batch_keep_mask, sample_batch
from tests.token_guard import assert_tokens_match_guarded
from _torch_threads import one_thread  # noqa: F401

SEED = 0x5E7
CPU = torch.device("cpu")
# head_dim 128: decode goes through the decode_attn2 path (plain on CPU)
KCFG = dict(vocab_size=256, d_model=256, n_layers=2, n_heads=2, n_kv_heads=1,
            d_ff=512, max_seq_len=128)


@pytest.fixture(scope="module")
def setup():
    jcfg = JM.LlamaConfig(**KCFG)
    jparams = JM.quantize_params(JM.init_params(jcfg, jax.random.key(SEED)),
                                 bits=4)
    return (jcfg, jparams, convert.config_from_jax(jcfg),
            convert.params_from_jax(jparams, device=CPU))


def _prompts(n, lo, hi, vocab, seed):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, int(rng.integers(lo, hi)))]
            for _ in range(n)]


def _single(cfg, params, prompt, n_new):
    """Port single-request greedy generation, no engine."""
    cache = TM.init_kv_cache(cfg, 1, max_len=128, device=CPU)
    logits, cache = TM.prefill(cfg, params,
                               torch.tensor([prompt], dtype=torch.int32), cache)
    toks, pos = [], len(prompt)
    tok = int(logits.argmax(-1)[0])
    for _ in range(n_new):
        toks.append(tok)
        logits, cache = TM.decode_step(cfg, params,
                                       torch.tensor([tok], dtype=torch.int32),
                                       torch.tensor([pos], dtype=torch.int32),
                                       cache)
        tok = int(logits.argmax(-1)[0])
        pos += 1
    return toks


def _port_forward(cfg, params):
    def fwd(toks):
        lg, _ = TM.forward(cfg, params, torch.from_numpy(np.array(toks)))
        return lg.numpy()
    return fwd


def _engine_tokens(cfg, params, prompts, n_new, **ec):
    eng = Engine(cfg, params, EngineConfig(**ec), device=CPU)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p,
                           sampling=SamplingParams(max_new_tokens=n_new)))
    done = sorted(eng.run(), key=lambda r: r.rid)
    assert len(done) == len(prompts)
    return eng, done


def test_engine_matches_single_request_generation(setup):
    _, _, cfg, params = setup
    prompts = _prompts(5, 3, 12, cfg.vocab_size, SEED)
    eng, done = _engine_tokens(cfg, params, prompts, 6, batch_slots=2,
                               max_seq_len=128, prefill_pad=4)
    fwd = _port_forward(cfg, params)
    for p, req in zip(prompts, done):
        assert_tokens_match_guarded(fwd, p, req.tokens, _single(cfg, params, p, 6),
                                    tag=f"rid {req.rid}")
        assert req.ttft_s is not None and req.ttft_s >= 0
        assert len(req.logprobs) == 6 and all(lp <= 0 for lp in req.logprobs)
    m = eng.metrics
    assert m.decode_tokens > 0 and m.decode_tokens_per_s > 0
    assert m.prefill_tokens == sum(len(p) for p in prompts)


def test_engine_runs_to_max_seq_len(setup):
    """Requests that fill the cache to max_seq_len: their slots step on past
    it until the block that finishes them is read back, and those writes
    are dropped, as in the reference."""
    _, _, cfg, params = setup
    prompts = _prompts(2, 20, 21, cfg.vocab_size, SEED + 3)
    _, done = _engine_tokens(cfg, params, prompts, 12, batch_slots=2,
                             max_seq_len=32, prefill_pad=4, decode_block=4)
    fwd = _port_forward(cfg, params)
    for p, req in zip(prompts, done):
        assert len(p) + len(req.tokens) == 32
        assert_tokens_match_guarded(fwd, p, req.tokens,
                                    _single(cfg, params, p, 12),
                                    tag=f"rid {req.rid}")


def test_engine_matches_jax_engine(setup):
    jcfg, jparams, cfg, params = setup
    prompts = _prompts(3, 5, 9, cfg.vocab_size, SEED + 1)   # one pad bucket
    ec = dict(batch_slots=2, max_seq_len=128, prefill_pad=8, decode_block=4)
    jeng = JEngine(jcfg, jparams, JEngineConfig(**ec))
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(rid=i, prompt=p,
                             sampling=JSamplingParams(max_new_tokens=5)))
    want = sorted(jeng.run(), key=lambda r: r.rid)
    _, got = _engine_tokens(cfg, params, prompts, 5, **ec)

    def jfwd(toks):
        return JM.forward(jcfg, jparams, jnp.asarray(toks))[0]

    for p, g, w in zip(prompts, got, want):
        assert_tokens_match_guarded(jfwd, p, g.tokens, w.tokens,
                                    tag=f"rid {g.rid}")


def test_engine_bursts_are_powers_of_two(setup):
    _, _, cfg, params = setup
    eng = Engine(cfg, params, EngineConfig(batch_slots=4, max_seq_len=128,
                                           prefill_pad=16), device=CPU)
    sizes = []
    admit = eng._admit_one_shot

    def spy(batch):
        sizes.append(len(batch))
        return admit(batch)

    eng._admit_one_shot = spy
    for i, p in enumerate(_prompts(3, 4, 10, cfg.vocab_size, SEED + 2)):
        eng.submit(Request(rid=i, prompt=p,
                           sampling=SamplingParams(max_new_tokens=3)))
    assert len(eng.run()) == 3
    assert sizes == [2, 1]


def test_engine_stops_and_validates(setup):
    _, _, cfg, params = setup
    prompt = [5, 6, 7]
    first = _single(cfg, params, prompt, 1)[0]
    eng = Engine(cfg, params, EngineConfig(batch_slots=1, max_seq_len=64,
                                           prefill_pad=4), device=CPU)
    eng.submit(Request(rid=0, prompt=prompt,
                       sampling=SamplingParams(max_new_tokens=50,
                                               eos_token=first)))
    assert eng.run()[0].tokens == [first]

    eng = Engine(cfg, params, EngineConfig(batch_slots=1, max_seq_len=16,
                                           prefill_pad=4), device=CPU)
    eng.submit(Request(rid=0, prompt=list(range(1, 13)),
                       sampling=SamplingParams(max_new_tokens=10)))
    with pytest.raises(ValueError):
        eng.run()
    with pytest.raises(ValueError):
        eng.submit(Request(rid=1, prompt=[]))
    with pytest.raises(ValueError):
        eng.submit(Request(rid=1, prompt=[1], sampling=SamplingParams(top_k=200)))


def test_engine_sampled_requests_complete(setup):
    _, _, cfg, params = setup
    eng = Engine(cfg, params, EngineConfig(batch_slots=4, max_seq_len=128,
                                           prefill_pad=8), device=CPU)
    sps = [SamplingParams(max_new_tokens=7),
           SamplingParams(temperature=0.8, top_p=0.95, max_new_tokens=7),
           SamplingParams(temperature=1.0, top_k=5, max_new_tokens=7),
           SamplingParams(temperature=0.7, min_p=0.1, max_new_tokens=7)]
    for i, (p, sp) in enumerate(zip(_prompts(4, 3, 20, cfg.vocab_size, SEED),
                                    sps)):
        eng.submit(Request(rid=i, prompt=p, sampling=sp))
    done = eng.run()
    assert len(done) == 4
    for r in done:
        assert len(r.tokens) == 7 and all(0 <= t < cfg.vocab_size for t in r.tokens)
        assert all(np.isfinite(lp) and lp <= 0 for lp in r.logprobs)


def test_engine_unported_options_raise(setup, monkeypatch):
    _, _, cfg, params = setup
    # speculation serves since queue 1 item 10 was ported
    # (tests/test_torch_speculative.py); a draft model is refused with the
    # reference's ValueErrors without speculate, or of another vocab
    with pytest.raises(ValueError, match="speculate > 0"):
        Engine(cfg, params, EngineConfig(max_seq_len=128),
               draft=(cfg, params), device=CPU)
    with pytest.raises(ValueError, match="vocab"):
        Engine(cfg, params, EngineConfig(max_seq_len=128, speculate=2),
               draft=(dataclasses.replace(cfg, vocab_size=128), params),
               device=CPU)
    # track_history serves since queue 1 item 7 was ported
    # (test_engine_track_history_serves); without it a penalty is refused
    # with the reference's ValueError
    eng = Engine(cfg, params, EngineConfig(max_seq_len=128), device=CPU)
    with pytest.raises(ValueError, match="track_history"):
        eng.submit(Request(rid=0, prompt=[1],
                           sampling=SamplingParams(repetition_penalty=1.2)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, params, EngineConfig(max_seq_len=128))


# track_history and the penalties raised before queue 1 item 7 was ported:
# with the history on and every penalty off the engine gives the tokens of
# single-request generation, and a penalized request serves beside them.
def test_engine_track_history_serves(setup):
    _, _, cfg, params = setup
    prompts = _prompts(3, 4, 12, cfg.vocab_size, SEED + 10)
    eng, done = _engine_tokens(cfg, params, prompts, 6, batch_slots=2,
                               max_seq_len=128, prefill_pad=4,
                               decode_block=4, track_history=True)
    fwd = _port_forward(cfg, params)
    for p, req in zip(prompts, done):
        assert_tokens_match_guarded(fwd, p, req.tokens,
                                    _single(cfg, params, p, 6),
                                    tag=f"rid {req.rid}")
    eng.submit(Request(rid=9, prompt=prompts[0], sampling=SamplingParams(
        repetition_penalty=1.3, frequency_penalty=0.5, max_new_tokens=6)))
    (req,) = [r for r in eng.run() if r.rid == 9]
    assert len(req.tokens) == 6


# Options of ROADMAP.md queue 1 item 8 that raised before it was ported:
# each now serves, with the tokens of single-request generation.
@pytest.mark.parametrize("ec", [dict(prefill_chunk=16),
                                dict(attn_windows=(64,)),
                                dict(prefill_chunk=16, prefix_cache=2,
                                     prefix_cache_auto=True)])
def test_engine_item8_options_serve(setup, ec):
    _, _, cfg, params = setup
    prompts = _prompts(3, 5, 40, cfg.vocab_size, SEED + 8)
    _, done = _engine_tokens(cfg, params, prompts, 5, batch_slots=2,
                             max_seq_len=128, decode_block=4, **ec)
    fwd = _port_forward(cfg, params)
    for p, req in zip(prompts, done):
        assert_tokens_match_guarded(fwd, p, req.tokens,
                                    _single(cfg, params, p, 5),
                                    tag=f"rid {req.rid}")


def test_engine_snapshot_round_trip(setup):
    """snapshot() serves where it raised: restored into a fresh engine, the
    run finishes with the uninterrupted run's tokens."""
    _, _, cfg, params = setup
    prompts = _prompts(3, 4, 12, cfg.vocab_size, SEED + 9)

    def make():
        eng = Engine(cfg, params, EngineConfig(batch_slots=2, max_seq_len=128,
                                               prefill_pad=4, decode_block=4),
                     device=CPU)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p,
                               sampling=SamplingParams(max_new_tokens=6)))
        return eng

    want = {r.rid: r.tokens for r in make().run()}
    eng = make()
    eng._admit()
    eng._step_decode()
    state = eng.snapshot()
    fresh = Engine(cfg, params, EngineConfig(batch_slots=2, max_seq_len=128,
                                             prefill_pad=4, decode_block=4),
                   device=CPU)
    fresh.restore(state)
    assert {r.rid: r.tokens for r in fresh.run()} == want


def test_sampler_greedy_and_modes():
    rng = np.random.default_rng(SEED)
    logits = rng.normal(0, 2, (6, 50)).astype(np.float32)
    z = np.zeros(6, np.float32)
    want = np.asarray(j_sample_batch(jnp.asarray(logits), jnp.asarray(z),
                                     jnp.zeros(6, jnp.int32), jnp.ones(6),
                                     jax.random.key(0)))
    got = sample_batch(torch.from_numpy(logits), torch.from_numpy(z),
                       torch.zeros(6, dtype=torch.int32), torch.ones(6))
    np.testing.assert_array_equal(got.numpy(), want)
    one = torch.tensor([[0.0, 5.0, 1.0, -2.0]])
    gen = torch.Generator().manual_seed(0)
    assert int(sample(one, SamplingParams(temperature=0.0))[0]) == 1
    assert int(sample(one, SamplingParams(temperature=0.5, top_k=2), gen)[0]) in (1, 2)
    assert int(sample(one, SamplingParams(temperature=1.0, top_p=0.5), gen)[0]) == 1


# Draws: the PRNGs differ, so the keep-masks are compared as the sets of
# tokens each package ever draws (every kept token has >= ~1% mass, so
# N = 4000 draws cover it), and the frequencies within 0.05 of each other
# and of the exact softmax for the pure-temperature row (> 4 standard
# deviations of a binomial frequency at N = 4000).
def test_sampler_keep_masks_and_frequencies():
    rng = np.random.default_rng(SEED + 7)
    v, n = 24, 4000
    logits = rng.normal(0, 1.5, (5, v)).astype(np.float32)
    temps = np.array([0.0, 1.0, 0.7, 1.3, 1.0], np.float32)
    topk = np.array([0, 5, 0, 0, 0], np.int32)
    topp = np.array([1.0, 1.0, 0.8, 1.0, 1.0], np.float32)
    minp = np.array([0.0, 0.0, 0.0, 0.2, 0.0], np.float32)
    keys = jax.random.split(jax.random.key(SEED), n)
    jd = np.asarray(jax.vmap(lambda k: j_sample_batch(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(topk),
        jnp.asarray(topp), k, jnp.asarray(minp)))(keys))              # [n, 5]
    rep = lambda a: torch.from_numpy(np.tile(a, n))  # noqa: E731
    td = sample_batch(torch.from_numpy(np.tile(logits, (n, 1))), rep(temps),
                      rep(topk), rep(topp), torch.Generator().manual_seed(1),
                      rep(minp)).numpy().reshape(n, 5)
    lt = torch.from_numpy(logits) / torch.from_numpy(np.maximum(temps, 1e-6))[:, None]
    _, idx, keep, restricted = batch_keep_mask(
        lt, torch.from_numpy(topk), torch.from_numpy(topp), torch.from_numpy(minp))
    assert restricted.tolist() == [False, True, True, True, False]
    assert (jd[:, 0] == logits[0].argmax()).all() and (td[:, 0] == jd[:, 0]).all()
    for r in (1, 2, 3):
        kept = set(idx[r][keep[r]].tolist())
        assert set(jd[:, r].tolist()) == kept, r
        assert set(td[:, r].tolist()) == kept, r
    for r in range(1, 5):
        fj = np.bincount(jd[:, r], minlength=v) / n
        ft = np.bincount(td[:, r], minlength=v) / n
        assert np.abs(fj - ft).max() < 0.05, r
    exact = torch.softmax(torch.from_numpy(logits[4]), -1).numpy()
    assert np.abs(np.bincount(td[:, 4], minlength=v) / n - exact).max() < 0.05
