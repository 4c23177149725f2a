"""Token history, penalties and beam search in the port (serving/sampler.py,
serving/engine.py with track_history, models/generate.py) against the JAX
package on the same numpy inputs and the same tiny model: the penalty
functions equal JAX's element for element, the engine's greedy tokens
under penalties equal the JAX engine's (near-tie guard on the penalized
reference logits), sampled penalized draws match by frequency (the PRNGs
differ), and the reference's own cases (tests/test_penalties.py,
tests/test_beam.py) hold on the port."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from piquant_tpu.models import llama as JM
from piquant_tpu.models.generate import beam_search as j_beam_search
from piquant_tpu.serving import Engine as JEngine
from piquant_tpu.serving import EngineConfig as JEngineConfig
from piquant_tpu.serving import Request as JRequest
from piquant_tpu.serving import SamplingParams as JSamplingParams
from piquant_tpu.serving import sampler as JS
from piquant_tpu_torch import convert
from piquant_tpu_torch.models import llama as TM
from piquant_tpu_torch.models.generate import beam_search
from piquant_tpu_torch.serving import (Engine, EngineConfig, Request,
                                       SamplingParams, sample)
from piquant_tpu_torch.serving.sampler import (apply_freq_presence,
                                               apply_repetition_penalty)
from tests.token_guard import assert_tokens_match_guarded
from _torch_threads import one_thread  # noqa: F401

SEED = 0x0A1
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup():
    jcfg = JM.LlamaConfig.tiny(vocab=64)
    jparams = JM.quantize_params(JM.init_params(jcfg, jax.random.key(SEED)),
                                 bits=4)
    return (jcfg, jparams, convert.config_from_jax(jcfg),
            convert.params_from_jax(jparams, device=CPU))


def _penalty_inputs(seed):
    rng = np.random.default_rng(seed)
    b, v, s = 4, 48, 20
    return dict(
        logits=rng.normal(0, 2, (b, v)).astype(np.float32),
        hist=rng.integers(0, v, (b, s)).astype(np.int32),
        start=np.asarray([4, 0, 20, 7], np.int32),
        hlen=np.asarray([10, 20, 20, 0], np.int32),
        pen=np.asarray([1.3, 1.0, 0.7, 2.0], np.float32),
        freq=np.asarray([0.5, 0.0, 2.0, 0.3], np.float32),
        pres=np.asarray([0.25, 1.0, 0.0, 0.5], np.float32))


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_repetition_penalty_matches_jax(seed):
    a = _penalty_inputs(seed)
    want = np.asarray(JS.apply_repetition_penalty(
        jnp.asarray(a["logits"]), jnp.asarray(a["hist"]),
        jnp.asarray(a["hlen"]), jnp.asarray(a["pen"])))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = apply_repetition_penalty(t["logits"], t["hist"], t["hlen"],
                                   t["pen"])
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, a["logits"])


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_freq_presence_matches_jax_and_oracle(seed):
    a = _penalty_inputs(seed)
    want = np.asarray(JS.apply_freq_presence(
        jnp.asarray(a["logits"]), jnp.asarray(a["hist"]),
        jnp.asarray(a["start"]), jnp.asarray(a["hlen"]),
        jnp.asarray(a["freq"]), jnp.asarray(a["pres"])))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = apply_freq_presence(t["logits"], t["hist"], t["start"], t["hlen"],
                              t["freq"], t["pres"]).numpy()
    np.testing.assert_array_equal(got, want)
    oracle = a["logits"].copy()          # the reference test's numpy oracle
    for i in range(oracle.shape[0]):
        counts = np.zeros(oracle.shape[1])
        for j in range(a["start"][i], a["hlen"][i]):
            counts[a["hist"][i, j]] += 1
        oracle[i] -= a["freq"][i] * counts + a["pres"][i] * (counts > 0)
    np.testing.assert_allclose(got, oracle, rtol=1e-6)


def test_sample_with_history_matches_jax():
    a = _penalty_inputs(SEED + 2)
    sp = SamplingParams(repetition_penalty=1.5)
    want = np.asarray(JS.sample(jnp.asarray(a["logits"]),
                                JSamplingParams(repetition_penalty=1.5),
                                jax.random.key(0),
                                history=jnp.asarray(a["hist"])))
    got = sample(torch.from_numpy(a["logits"]), sp,
                 history=torch.from_numpy(a["hist"]))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="history"):
        sample(torch.from_numpy(a["logits"]), sp)


# Sampled draws under a repetition penalty: the PRNGs differ, so N = 4000
# draws of each package are compared by frequency, with each other and
# with the exact softmax of the penalized logits (0.05: > 4 standard
# deviations of a binomial frequency at N = 4000).
def test_penalized_draws_by_frequency():
    rng = np.random.default_rng(SEED + 3)
    v, n = 16, 4000
    logits = rng.normal(0, 1.0, (1, v)).astype(np.float32)
    hist = np.asarray([[0, 1, 2, 3, 3, 5]], np.int32)
    keys = jax.random.split(jax.random.key(SEED), n)
    jsp = JSamplingParams(temperature=1.0, repetition_penalty=2.0)
    jd = np.asarray(jax.vmap(lambda k: JS.sample(
        jnp.asarray(logits), jsp, k, history=jnp.asarray(hist)))(keys))[:, 0]
    td = sample(torch.from_numpy(np.tile(logits, (n, 1))),
                SamplingParams(temperature=1.0, repetition_penalty=2.0),
                torch.Generator().manual_seed(1),
                history=torch.from_numpy(np.tile(hist, (n, 1)))).numpy()
    pen = apply_repetition_penalty(
        torch.from_numpy(logits), torch.from_numpy(hist),
        torch.tensor([hist.shape[1]], dtype=torch.int32),
        torch.tensor([2.0]))
    exact = torch.softmax(pen[0], -1).numpy()
    fj = np.bincount(jd, minlength=v) / n
    ft = np.bincount(td, minlength=v) / n
    assert np.abs(fj - ft).max() < 0.05
    assert np.abs(ft - exact).max() < 0.05
    assert np.abs(exact - torch.softmax(torch.from_numpy(logits[0]),
                                        -1).numpy()).max() > 0.05


def _penalized_reference(jcfg, jparams, sp):
    """forward_fn for the token guard: the JAX package's raw logits of a
    sequence, penalized at each generated step as the engine penalizes
    them (repetition over prompt + generated, frequency and presence over
    the generated, the bias, EOS below min_new_tokens)."""
    def fwd(toks, plen):
        raw = np.array(JM.forward(jcfg, jparams, jnp.asarray(toks))[0],
                       np.float32)[0]
        seq = np.asarray(toks)[0]
        out = raw.copy()
        v = raw.shape[-1]
        for k in range(len(seq) - plen + 1):       # generated token index k
            t = plen - 1 + k
            hist = torch.from_numpy(seq[None, :plen + k].astype(np.int32))
            row = apply_repetition_penalty(
                torch.from_numpy(raw[t][None]), hist,
                torch.tensor([plen + k], dtype=torch.int32),
                torch.tensor([sp.repetition_penalty]))
            if k:
                row = apply_freq_presence(
                    row, hist, torch.tensor([plen], dtype=torch.int32),
                    torch.tensor([plen + k], dtype=torch.int32),
                    torch.tensor([sp.frequency_penalty]),
                    torch.tensor([sp.presence_penalty]))
            bias = np.zeros(v, np.float32)
            for tok, b in sp.logit_bias:
                bias[tok] = b
            row = row[0].numpy() + bias
            if sp.eos_token >= 0 and k + 1 <= sp.min_new_tokens:
                row[sp.eos_token] = -1e30
            out[t] = row
        return out[None]
    return fwd


SPS = [dict(repetition_penalty=1.2, max_new_tokens=8),
       dict(repetition_penalty=1.3, frequency_penalty=0.5,
            presence_penalty=0.5, max_new_tokens=8),
       dict(frequency_penalty=0.5, logit_bias=((7, -1e9), (11, 2.0)),
            max_new_tokens=8),
       dict(repetition_penalty=1.1, min_new_tokens=5, eos_token=3,
            max_new_tokens=8)]


def test_engine_penalties_match_jax_engine(setup):
    jcfg, jparams, cfg, params = setup
    rng = np.random.default_rng(SEED + 4)
    prompts = [[int(t) for t in rng.integers(1, 64, n)] for n in (5, 6, 7, 6)]
    ec = dict(batch_slots=2, max_seq_len=128, prefill_pad=8, decode_block=4,
              track_history=True)
    jeng = JEngine(jcfg, jparams, JEngineConfig(**ec))
    eng = Engine(cfg, params, EngineConfig(**ec), device=CPU)
    for i, (p, kw) in enumerate(zip(prompts, SPS)):
        jeng.submit(JRequest(rid=i, prompt=p, sampling=JSamplingParams(**kw)))
        eng.submit(Request(rid=i, prompt=p, sampling=SamplingParams(**kw)))
    want = sorted(jeng.run(), key=lambda r: r.rid)
    got = sorted(eng.run(), key=lambda r: r.rid)
    for p, kw, g, w in zip(prompts, SPS, got, want):
        fwd = _penalized_reference(jcfg, jparams, SamplingParams(**kw))
        assert_tokens_match_guarded(lambda t: fwd(t, len(p)), p, g.tokens,
                                    w.tokens, tag=f"rid {g.rid}")
        same = 0        # raw-model logprobs where the tokens agree
        while (same < min(len(g.tokens), len(w.tokens))
               and g.tokens[same] == w.tokens[same]):
            same += 1
        np.testing.assert_allclose(g.logprobs[:same], w.logprobs[:same],
                                   atol=2e-2)
    assert 7 not in got[2].tokens and 3 not in got[3].tokens[:5]


def _engine(cfg, params, **kw):
    return Engine(cfg, params, EngineConfig(batch_slots=kw.pop("slots", 1),
                                            max_seq_len=128, decode_block=4,
                                            track_history=True, **kw),
                  device=CPU)


def _run(eng, rid, prompt, **sp):
    r = Request(rid=rid, prompt=prompt, sampling=SamplingParams(**sp))
    eng.submit(r)
    eng.run()
    return r


# The reference's own cases (tests/test_penalties.py) on the port.
def test_frequency_penalty_forbids_repeats(setup):
    _, _, cfg, params = setup
    r = _run(_engine(cfg, params, slots=2), 0, [1, 2, 3], temperature=0.0,
             frequency_penalty=1000.0, max_new_tokens=20)
    assert len(r.tokens) == 20 and len(set(r.tokens)) == 20, r.tokens


def test_presence_penalty_forbids_repeats(setup):
    _, _, cfg, params = setup
    r = _run(_engine(cfg, params), 0, [5], temperature=0.0,
             presence_penalty=1000.0, max_new_tokens=16)
    assert len(set(r.tokens)) == len(r.tokens), r.tokens


def test_logit_bias_dominates_greedy(setup):
    _, _, cfg, params = setup
    r = _run(_engine(cfg, params), 0, [1, 2], temperature=0.0,
             logit_bias=((37, 1000.0),), max_new_tokens=8)
    assert r.tokens == [37] * 8, r.tokens


def test_negative_bias_bans_token(setup):
    _, _, cfg, params = setup
    r0 = _run(_engine(cfg, params), 0, [9], temperature=0.0,
              max_new_tokens=6)
    fav = max(set(r0.tokens), key=r0.tokens.count)
    r1 = _run(_engine(cfg, params), 1, [9], temperature=0.0,
              max_new_tokens=6, logit_bias=((fav, -1e9),))
    assert fav not in r1.tokens, (fav, r1.tokens)


def test_penalties_require_track_history(setup):
    _, _, cfg, params = setup
    eng = Engine(cfg, params, EngineConfig(batch_slots=1, max_seq_len=64),
                 device=CPU)
    for sp in (dict(frequency_penalty=0.5), dict(logit_bias=((3, 1.0),)),
               dict(repetition_penalty=1.2), dict(min_new_tokens=2)):
        with pytest.raises(ValueError, match="track_history"):
            eng.submit(Request(rid=0, prompt=[1],
                               sampling=SamplingParams(**sp)))
    with pytest.raises(ValueError, match="outside vocab"):
        _engine(cfg, params).submit(Request(rid=2, prompt=[1], sampling=(
            SamplingParams(logit_bias=((9999, 1.0),)))))


def test_min_new_tokens_suppresses_eos(setup):
    _, _, cfg, params = setup
    r0 = _run(_engine(cfg, params), 0, [7, 8], temperature=0.0,
              max_new_tokens=4)
    eos = r0.tokens[0]
    r1 = _run(_engine(cfg, params), 1, [7, 8], temperature=0.0,
              max_new_tokens=12, eos_token=eos, min_new_tokens=8)
    assert len(r1.tokens) >= 8, r1.tokens
    assert eos not in r1.tokens[:7], r1.tokens


def test_stop_sequences_trimmed(setup):
    _, _, cfg, params = setup
    r0 = _run(_engine(cfg, params), 0, [3, 4], temperature=0.0,
              max_new_tokens=10)
    stop = tuple(r0.tokens[4:6])
    r1 = _run(_engine(cfg, params), 1, [3, 4], temperature=0.0,
              max_new_tokens=10, stop_sequences=(stop,))
    assert r1.tokens == r0.tokens[:4], (r1.tokens, r0.tokens)
    assert len(r1.logprobs) == len(r1.tokens)


def test_history_buffer_in_place(setup):
    """The history is [B, max_seq_len + 2] int32 on the engine's device,
    the same tensor across blocks, holding prompt + generated tokens."""
    _, _, cfg, params = setup
    eng = _engine(cfg, params)
    buf = eng._hist
    assert buf.shape == (1, 130) and buf.dtype == torch.int32
    r = _run(eng, 0, [4, 5, 6], temperature=0.0, repetition_penalty=1.2,
             max_new_tokens=9)
    assert eng._hist is buf
    assert buf[0, :12].tolist() == [4, 5, 6] + r.tokens


# Beam search: the reference's cases (tests/test_beam.py) on the port.
def _greedy(cfg, params, prompt, n_new):
    cache = TM.init_kv_cache(cfg, 1, max_len=128, device=CPU)
    logits, cache = TM.prefill(cfg, params,
                               torch.tensor([prompt], dtype=torch.int32),
                               cache)
    toks, lp_sum, pos = [], 0.0, len(prompt)
    for _ in range(n_new):
        lp = torch.log_softmax(logits.float(), -1)[0]
        tok = int(lp.argmax())
        lp_sum += float(lp[tok])
        toks.append(tok)
        logits, cache = TM.decode_step(
            cfg, params, torch.tensor([tok], dtype=torch.int32),
            torch.tensor([pos], dtype=torch.int32), cache)
        pos += 1
    return toks, lp_sum


def test_beam1_equals_greedy(setup):
    jcfg, jparams, cfg, params = setup
    prompt = [3, 7, 1]
    want, want_lp = _greedy(cfg, params, prompt, 8)
    hyps = beam_search(cfg, params, prompt, n_beams=1, max_new_tokens=8,
                       device=CPU)
    assert len(hyps) == 1 and hyps[0].tokens == want
    np.testing.assert_allclose(hyps[0].logprob, want_lp, rtol=1e-4, atol=1e-4)
    jh = j_beam_search(jcfg, jparams, prompt, n_beams=1, max_new_tokens=8)

    def jfwd(toks):
        return JM.forward(jcfg, jparams, jnp.asarray(toks))[0]

    assert_tokens_match_guarded(jfwd, prompt, hyps[0].tokens, jh[0].tokens)


def test_wider_beam_never_worse(setup):
    _, _, cfg, params = setup
    prompt, n_new = [9, 2], 8
    _, greedy_lp = _greedy(cfg, params, prompt, n_new)
    hyps = beam_search(cfg, params, prompt, n_beams=4, max_new_tokens=n_new,
                       device=CPU)
    assert hyps and all(len(h.tokens) == n_new for h in hyps)
    assert hyps[0].logprob >= greedy_lp - 1e-4, (hyps[0].logprob, greedy_lp)
    assert all(hyps[i].score >= hyps[i + 1].score
               for i in range(len(hyps) - 1))


def test_eos_finalizes(setup):
    _, _, cfg, params = setup
    prompt = [5, 6]
    eos = _greedy(cfg, params, prompt, 6)[0][2]
    hyps = beam_search(cfg, params, prompt, n_beams=3, max_new_tokens=10,
                       eos_token=eos, device=CPU)
    assert hyps and all(eos not in h.tokens for h in hyps)
    assert any(len(h.tokens) < 10 for h in hyps)


def test_length_penalty_runs(setup):
    _, _, cfg, params = setup
    prompt = [4, 4]
    eos = _greedy(cfg, params, prompt, 6)[0][1]
    short = beam_search(cfg, params, prompt, n_beams=3, max_new_tokens=8,
                        eos_token=eos, length_penalty=0.0, device=CPU)
    long = beam_search(cfg, params, prompt, n_beams=3, max_new_tokens=8,
                       eos_token=eos, length_penalty=2.0, device=CPU)
    assert short and long
    assert all(np.isfinite(h.score) for h in short + long)


def test_beam_validation(setup):
    _, _, cfg, params = setup
    with pytest.raises(ValueError, match="non-empty"):
        beam_search(cfg, params, [], n_beams=2, device=CPU)
    with pytest.raises(ValueError, match="exceeds"):
        beam_search(cfg, params, [1], max_new_tokens=10_000, device=CPU)
