"""Head dims of 384 and 512 on the CPU: the plain versions of the flash,
decode-attention (kv8 and kv4 state) and first flash-decode kernels
against the JAX package's Pallas kernels in interpret mode, tiny models of
those head dims against the JAX package's logits through a prefill and kv8
/ kv4 decode steps, and the port's Engine against its own single-request
generation on them.  The CUDA kernels at these widths
(csrc/flash_wide.cu, csrc/decode_wide.cu) are held against the same plain
versions in tests/test_torch_cuda.py (D 384, 512, 640-1024)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from piquant_tpu.models import llama as JM
from piquant_tpu.ops.pallas.attention import decode_attention as j_decode_v1
from piquant_tpu.ops.pallas.decode_attn2 import (
    decode_attention_state as j_decode_state)
from piquant_tpu.ops.pallas.flash import flash_prefill_masked as j_flash
from piquant_tpu_torch import convert
from piquant_tpu_torch.models import llama as TM
from piquant_tpu_torch.ops.cuda import _build
from piquant_tpu_torch.ops.cuda import attention as TA
from piquant_tpu_torch.ops.cuda import decode_attn2 as TDA
from piquant_tpu_torch.ops.cuda import flash as TF
from piquant_tpu_torch.serving import (Engine, EngineConfig, Request,
                                       SamplingParams)
from test_torch_kernels import _stacked_cache
from test_torch_kv4 import _random_kv4
from test_torch_model import _check_logits, _run_jax, _run_port
from tests.token_guard import assert_tokens_match_guarded
from _torch_threads import one_thread  # noqa: F401

SEED = 0x3D84
CPU = torch.device("cpu")
WIDE = [384, 512]


def _t(a):
    return convert.tensor_from_numpy(a, CPU)


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

# Flash output element by element within atol 2e-3, rtol 2e-2 (the causal
# flash bound, tests/test_torch_kernels.py): bf16 probabilities before the
# PV product in both, at running maxima of another tile order.  Rep 2 at B
# 2, T 256; the softcap (2, on scores spread by q and k at twice unit scale)
# and the sinks (the first head's lifted by 3) each move the context past
# that bound; the chunk's boundary falls inside both rows' prompts.
FLASH_CASES = {"causal": {}, "window": dict(window=100),
               "softcap": dict(softcap=2.0),
               "chunk": dict(chunk=96, pos0=(40, 0)),
               "sinks": dict(sinks=True)}


@pytest.mark.heavy_interpret
@pytest.mark.parametrize("d", WIDE)
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_plain_matches_pallas(d, case):
    b, hkv, rep, t = 2, 1, 2, 256
    kw = dict(FLASH_CASES[case])
    rng = np.random.default_rng(SEED + d + len(case))
    widen = 2.0 if case == "softcap" else 1.0
    q = rng.normal(0, widen, (b, hkv, rep, t, d)).astype(np.float32)
    k = rng.normal(0, widen, (b, hkv, t, d)).astype(np.float32)
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
    if case in ("softcap", "sinks"):
        bare = TF.flash_attn_plain(_t(q), _t(k), _t(v), sm, kw.get("window"))
        assert (np.abs(bare.numpy() - want)
                > 2e-3 + 2e-2 * np.abs(want)).any()


# Decode-attention state (m to f32 rounding, l within 2e-2, the normalized
# context within atol 2e-3, rtol 2e-2: tests/test_torch_kernels.py's
# bounds) over kv8 and kv4 caches at window starts; the pos = 0 row keeps
# the reference's sentinel.  A kv4 position is D / 2 bytes: dim j in the
# low nibble, dim j + D / 2 in the high one.
@pytest.mark.heavy_interpret
@pytest.mark.parametrize("d", WIDE)
@pytest.mark.parametrize("kv", ["kv8", "kv4"])
def test_decode_state_plain_matches_pallas(d, kv):
    rng = np.random.default_rng(SEED + 10 + d + (kv == "kv4"))
    nl, b, hkv, rep, s = 2, 3, 1, 4, 1024
    cache = (_random_kv4(rng, nl, b, hkv, s, d) if kv == "kv4"
             else _stacked_cache(rng, nl, b, hkv, s, d))
    q = rng.normal(0, 1, (b, hkv, rep, d)).astype(np.float32)
    pos = np.array([0, 700, 1023], np.int32)
    starts = np.array([0, 301, 0], np.int32)
    with jax.enable_x64(False):
        acc, m, l = (np.asarray(a) for a in j_decode_state(
            jnp.asarray(q), *(jnp.asarray(a) for a in cache),
            jnp.asarray(pos), d ** -0.5, layer=1, starts=jnp.asarray(starts),
            interpret=True))
    tacc, tm, tl = (a.numpy() for a in TDA.decode_attention_state(
        _t(q), *(_t(a) for a in cache), _t(pos), d ** -0.5, layer=1,
        starts=_t(starts)))
    assert (tm[0] == -1e30).all() and (tl[0] == 0).all()
    assert (tacc[0] == 0).all()
    np.testing.assert_allclose(tm, m, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl, l, rtol=2e-2)
    np.testing.assert_allclose(tacc[1:] / tl[1:], acc[1:] / l[1:],
                               atol=2e-3, rtol=2e-2)


# The first flash-decode kernel's context: the same arithmetic in another
# summation order (tests/test_torch_fused_engine.py's KERNEL_TOL).
@pytest.mark.heavy_interpret
@pytest.mark.parametrize("d", WIDE)
def test_decode_v1_plain_matches_pallas(d):
    rng = np.random.default_rng(SEED + 20 + d)
    b, hkv, rep, s = 2, 1, 4, 1024
    args = (rng.normal(0, 1, (b, hkv, rep, d)).astype(np.float32),
            rng.integers(-127, 128, (b, hkv, s, d)).astype(np.int8),
            rng.uniform(0.001, 0.02, (b, hkv, s, 1)).astype(np.float32),
            rng.integers(-127, 128, (b, hkv, s, d)).astype(np.int8),
            rng.uniform(0.001, 0.02, (b, hkv, s, 1)).astype(np.float32),
            np.array([0, 900], np.int32))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_decode_v1(*(jnp.asarray(a) for a in args),
                                      d ** -0.5))
    got = TA.decode_attention(*(_t(a) for a in args), d ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


# A split edge with a few live positions on one side: the Pallas kernel
# rounds its probabilities to bf16 at its 512-position chunk's running
# maximum, the plain version (the jnp form's function) at the global one,
# and the two part by more than atol 2e-3 at rtol 2e-2 there.  Its gap over
# 8 seeds (tools/split_edge.py reference, these windows, D 128-1024): up to
# 4.61e-3 (kv8; an atol of 2.97e-3 needed at rtol 2e-2) and 2.4e-4 (kv4).
# The port's kernels round at their own splits' maxima and stay within the
# same bound on the card (test_torch_cuda.py::test_decode_attn2_split_edges).
SPLIT_EDGE_ATOL = 5e-3


@pytest.mark.heavy_interpret
@pytest.mark.parametrize("kv", ["kv8", "kv4"])
def test_decode_state_split_edge_gap(kv):
    rng = np.random.default_rng(SEED + 30 + (kv == "kv4"))
    nl, hkv, rep, s, d = 1, 1, 4, 1024, 128
    windows = ((511, 700), (510, 700), (300, 513), (300, 514), (511, 513),
               (510, 514), (511, 512), (0, 513))
    b = len(windows)
    cache = (_random_kv4(rng, nl, b, hkv, s, d) if kv == "kv4"
             else _stacked_cache(rng, nl, b, hkv, s, d))
    q = rng.normal(0, 1, (b, hkv, rep, d)).astype(np.float32)
    starts = np.array([w[0] for w in windows], np.int32)
    pos = np.array([w[1] for w in windows], np.int32)
    with jax.enable_x64(False):
        acc, m, l = (np.asarray(a) for a in j_decode_state(
            jnp.asarray(q), *(jnp.asarray(a) for a in cache),
            jnp.asarray(pos), d ** -0.5, layer=0, starts=jnp.asarray(starts),
            interpret=True))
    tacc, tm, tl = (a.numpy() for a in TDA.decode_attention_state(
        _t(q), *(_t(a) for a in cache), _t(pos), d ** -0.5, layer=0,
        starts=_t(starts)))
    np.testing.assert_allclose(tm, m, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tacc / tl, acc / l, atol=SPLIT_EDGE_ATOL,
                               rtol=2e-2)


# ---------------------------------------------------------------------------
# the CUDA entry point each head dim takes
# ---------------------------------------------------------------------------

NAMES = ("pq_flash_prefill", "pq_decode_attn2", "pq_decode_attn2_kv4",
         "pq_decode_attn")


@pytest.mark.parametrize("d", [128, 256, 384, 512, 640, 768, 896, 1024,
                               64, 192, 320, 1152, 2048])
def test_attention_entry_by_head_dim(d):
    """128 and 256 take flash.cu's and decode_attn2.cu's instances, the
    multiples of 128 from 384 to 1024 their `_wide` forms (flash_wide.cu,
    decode_wide.cu); every other head dim raises NotImplementedError naming
    the queue item, and every named entry point is bound."""
    for name in NAMES:
        if d in (128, 256):
            assert _build.attention_entry(name, d) == name
        elif d % 128 == 0 and 384 <= d <= 1024:
            got = _build.attention_entry(name, d)
            assert got == name + "_wide" and got in _build.SIGNATURES
        else:
            with pytest.raises(NotImplementedError, match="queue 2 item 3"):
                _build.attention_entry(name, d)


# ---------------------------------------------------------------------------
# tiny wide-head models against JAX, and the Engine
# ---------------------------------------------------------------------------

def _wide_cfg(hd, kv_bits):
    """2 layers, 2 query heads over 1 kv head (rep 2) of head_dim hd."""
    return JM.LlamaConfig(vocab_size=256, d_model=256, n_layers=2, n_heads=2,
                          n_kv_heads=1, d_ff=512, max_seq_len=256,
                          head_dim_override=hd, kv_bits=kv_bits)


@pytest.fixture(scope="module", params=[(384, 8), (384, 4), (512, 8),
                                        (512, 4)],
                ids=lambda p: f"d{p[0]}-kv{p[1]}")
def wide_model(request):
    """The JAX float init quantized to INT4 by the JAX package and carried
    across with `convert` (both packages hold the same codes)."""
    hd, kv_bits = request.param
    jcfg = _wide_cfg(hd, kv_bits)
    jparams = JM.quantize_params(
        JM.init_params(jcfg, jax.random.key(SEED + hd + kv_bits)), bits=4)
    cfg = convert.config_from_jax(jcfg)
    assert cfg.head_dim == hd and cfg.kv_bits == kv_bits
    return jcfg, jparams, cfg, convert.params_from_jax(jparams, device=CPU)


def test_wide_model_matches_jax(wide_model, monkeypatch):
    """A 128-token prefill (flash's plain version once a layer) and 3 decode
    steps (the kv8 or kv4 decode state's once a layer a step) against the
    JAX package's run of the same INT4 params, within
    tests/test_torch_model.py's LOGIT_TOL and near-tie guard."""
    jcfg, jparams, cfg, params = wide_model
    seen = []
    for mod, name in ((TF, "flash_attn_plain"), (TDA, "decode_attn2_plain")):
        fn = getattr(mod, name)

        def spy(q, *a, fn=fn, name=name, **kw):
            seen.append((name, q.shape[-1]))
            return fn(q, *a, **kw)
        monkeypatch.setattr(mod, name, spy)
    rng = np.random.default_rng(SEED + 40)
    toks = jnp.asarray(rng.integers(1, cfg.vocab_size, (2, 128 + 3)),
                       jnp.int32)
    got = _run_port(cfg, params, toks, 3)
    hd = cfg.head_dim
    assert sorted(seen) == ([("decode_attn2_plain", hd)] * 6
                            + [("flash_attn_plain", hd)] * 2)
    _check_logits(got, _run_jax(jcfg, jparams, toks, 3, jit=True))


def _single(cfg, params, prompt, n_new, max_len):
    """The port's single-request greedy prefill + decode."""
    cache = TM.init_kv_cache(cfg, 1, max_len=max_len, device=CPU)
    logits, cache = TM.prefill(cfg, params,
                               torch.tensor([prompt], dtype=torch.int32),
                               cache)
    toks, pos = [], len(prompt)
    tok = int(logits.argmax(-1)[0])
    for _ in range(n_new):
        toks.append(tok)
        logits, cache = TM.decode_step(
            cfg, params, torch.tensor([tok], dtype=torch.int32),
            torch.tensor([pos], dtype=torch.int32), cache)
        tok = int(logits.argmax(-1)[0])
        pos += 1
    return toks


def test_wide_engine_matches_single_request(wide_model):
    """Three greedy requests through an Engine of 2 slots (whole-tile
    prompts of 128, so the prefill takes flash's plain version; one
    request waits for a slot) against single-request generation, under
    the near-tie guard (tests/token_guard.py)."""
    _, _, cfg, params = wide_model
    rng = np.random.default_rng(SEED + 50)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, 128)]
               for _ in range(3)]
    eng = Engine(cfg, params, EngineConfig(batch_slots=2, max_seq_len=256,
                                           prefill_pad=128, decode_block=4),
                 device=CPU)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p,
                           sampling=SamplingParams(max_new_tokens=6)))
    done = sorted(eng.run(), key=lambda r: r.rid)
    assert len(done) == 3

    def fwd(toks):
        lg, _ = TM.forward(cfg, params, torch.from_numpy(np.array(toks)))
        return lg.numpy()

    for p, req in zip(prompts, done):
        assert_tokens_match_guarded(fwd, p, req.tokens,
                                    _single(cfg, params, p, 6, 256),
                                    tag=f"rid {req.rid}")
