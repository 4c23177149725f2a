"""GQA reps above 8 on the CPU: the plain versions of the decode-attention
kernels (kv8 and kv4 state, the first flash-decode kernel's context) and
of flash prefill at reps 12 and 16 against the JAX package's Pallas
kernels in interpret mode, and a tiny Qwen3-MoE checkpoint of 16 query
heads over 1 kv head loaded by the port and held against the JAX
package's logits and transformers'.  The CUDA kernels at these reps are
held against the same plain versions in tests/test_torch_cuda.py (reps
9, 12, 16, 64 and 160)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import transformers
from jax.experimental.pallas import tpu as pltpu

from piquant_tpu.models import llama as JM
from piquant_tpu.models.loader import load_from_hf as j_load
from piquant_tpu.ops.pallas.attention import decode_attention as j_decode_v1
from piquant_tpu.ops.pallas.decode_attn2 import (
    decode_attention_state as j_decode_state)
from piquant_tpu.ops.pallas.flash import flash_prefill_masked as j_flash
from piquant_tpu_torch import convert
from piquant_tpu_torch.models import loader as TL
from piquant_tpu_torch.models import llama as TM
from piquant_tpu_torch.ops.cuda import attention as TA
from piquant_tpu_torch.ops.cuda import decode_attn2 as TDA
from piquant_tpu_torch.ops.cuda import flash as TF
from test_torch_kernels import _stacked_cache
from test_torch_kv4 import _random_kv4
from test_torch_model import _check_logits, _run_jax, _run_port
from _torch_threads import one_thread  # noqa: F401

SEED = 0x6A16
CPU = torch.device("cpu")
REPS = [12, 16]


def _t(a):
    return convert.tensor_from_numpy(a, CPU)


# Flash output element by element within atol 2e-3, rtol 2e-2 (the causal
# flash bound: bf16 probabilities before the PV product in both, at
# running maxima of another tile order), causal and under a window of 100.
# The three Pallas comparisons take the repo's heavy_interpret lock
# (tests/conftest.py): interpret-mode kernels at these reps run long enough
# to meet the futex deadlock that another JAX process on the machine can
# cause (NOTES.md).
@pytest.mark.heavy_interpret
@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("window", [None, 100])
def test_flash_plain_matches_pallas(rep, window):
    b, hkv, t, d = 1, 1, 256, 128
    rng = np.random.default_rng(SEED + rep + (window or 0))
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


# Decode-attention state (m to f32 rounding, l within 2e-2, the normalized
# context within atol 2e-3, rtol 2e-2: tests/test_torch_kernels.py's
# bounds) over kv8 and kv4 caches at window starts; the pos = 0 row keeps
# the reference's sentinel.
@pytest.mark.heavy_interpret
@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("kv", ["kv8", "kv4"])
def test_decode_state_plain_matches_pallas(rep, kv):
    rng = np.random.default_rng(SEED + rep + (kv == "kv4"))
    nl, b, hkv, s, d = 2, 3, 1, 1024, 128
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
@pytest.mark.parametrize("rep", REPS)
def test_decode_v1_plain_matches_pallas(rep):
    rng = np.random.default_rng(SEED + 100 + rep)
    b, hkv, s, d = 2, 1, 1024, 128
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


@pytest.fixture(scope="module")
def qwen3_moe_rep16(tmp_path_factory):
    """A tiny Qwen3-MoE checkpoint of Qwen3-235B-A22B's attention geometry
    cut down: 16 query heads over 1 kv head (rep 16) at head_dim 128, so
    the port's prefill and decode take flash and decode_attn2's plain
    versions; 4 experts, top 2."""
    torch.manual_seed(SEED)
    conf = transformers.Qwen3MoeConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=16, num_key_value_heads=1,
        head_dim=128, max_position_embeddings=256, rope_theta=10_000.0,
        rms_norm_eps=1e-5, num_experts=4, num_experts_per_tok=2,
        moe_intermediate_size=32, norm_topk_prob=True,
        tie_word_embeddings=False, attn_implementation="eager")
    model = transformers.Qwen3MoeForCausalLM(conf).eval()
    path = tmp_path_factory.mktemp("qwen3_moe_rep16")
    model.save_pretrained(path, safe_serialization=True)
    return model, str(path)


def test_qwen3_moe_rep16_matches_jax(qwen3_moe_rep16):
    """f32 logits of a 10-token prompt: the port against the JAX package's
    (eager) within 2e-3, and against transformers' within 3e-3 (the JAX
    package's own logits lie 2.47e-3 from transformers' on this model)."""
    model, path = qwen3_moe_rep16
    jcfg, jparams = j_load(model, dtype=jnp.float32)
    cfg, params = TL.load_from_hf(path, dtype=torch.float32, device="cpu")
    assert cfg.n_heads // cfg.n_kv_heads == 16 and cfg.head_dim == 128
    assert cfg == convert.config_from_jax(jcfg)
    rng = np.random.default_rng(SEED + 1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 10))
    with torch.no_grad():
        want = model(torch.tensor(tokens)).logits.numpy()
    with jax.disable_jit():
        jgot = np.asarray(JM.forward(jcfg, jparams,
                                     jnp.asarray(tokens, jnp.int32))[0])
    got = TM.forward(cfg, params,
                     torch.from_numpy(tokens).to(torch.int32))[0].numpy()
    np.testing.assert_allclose(got, jgot, atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(got, want, atol=3e-3, rtol=3e-3)


def test_qwen3_moe_rep16_cache_matches_jax(qwen3_moe_rep16, monkeypatch):
    """The INT4 load served through the kv8 cache: a 128-token prefill
    (flash's plain version at rep 16, once a layer) and 3 decode steps
    (decode_attn2's at rep 16, once a layer a step) against the JAX
    package's run of its own INT4 load, within tests/test_torch_model.py's
    LOGIT_TOL and near-tie guard."""
    model, path = qwen3_moe_rep16
    jcfg, jparams = j_load(model, quantize_bits=4)
    cfg, params = TL.load_from_hf(path, quantize_bits=4, device="cpu")
    reps = []
    for mod, name in ((TF, "flash_attn_plain"), (TDA, "decode_attn2_plain")):
        fn = getattr(mod, name)

        def spy(q, *a, fn=fn, name=name, **kw):
            reps.append((name, q.shape[2]))
            return fn(q, *a, **kw)
        monkeypatch.setattr(mod, name, spy)
    rng = np.random.default_rng(SEED + 2)
    toks = jnp.asarray(rng.integers(1, cfg.vocab_size, (2, 128 + 3)),
                       jnp.int32)
    got = _run_port(cfg, params, toks, 3)
    assert sorted(reps) == ([("decode_attn2_plain", 16)] * 6
                            + [("flash_attn_plain", 16)] * 2)
    _check_logits(got, _run_jax(jcfg, jparams, toks, 3, jit=True))
