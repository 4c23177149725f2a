"""The port's Llama forward (prefill + decode) against the JAX package's on
the CPU, with the JAX weights carried across by params_from_jax."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from piquant_tpu.models import llama as JM
from piquant_tpu_torch import convert
from piquant_tpu_torch.models import llama as TM
from piquant_tpu_torch.ops.cuda import decode_attn2 as TDA
from piquant_tpu_torch.ops.cuda import flash as TF
from piquant_tpu_torch.ops.cuda import qmatmul as TQ

SEED = 0x11A3
CPU = torch.device("cpu")

# head_dim 128, so the kernel-shaped paths (flash prefill, decode_attn2,
# the INT4 GEMV) run in the port
KCFG = dict(vocab_size=256, d_model=256, n_layers=2, n_heads=2, n_kv_heads=1,
            d_ff=512, max_seq_len=256)

# Whole-model logits: max |port - jax| <= 1.5e-2 * max |jax| (about twice
# the 0.6-0.7% measured).  The two packages take different attention paths
# on the CPU (the port always runs its kernels' plain versions; the JAX
# package materializes scores unless forced), and bf16 activations round at
# slightly different places.
LOGIT_TOL = 1.5e-2


def _setup(jcfg, seed):
    jparams = JM.quantize_params(JM.init_params(jcfg, jax.random.key(seed)),
                                 bits=4)
    cfg = convert.config_from_jax(jcfg)
    return jparams, cfg, convert.params_from_jax(jparams, device=CPU)


def _run_jax(jcfg, jparams, toks, n_dec, jit=False):
    b, t = toks.shape[0], toks.shape[1] - n_dec

    def run(p, tk):
        cache = JM.init_kv_cache(jcfg, b, max_len=jcfg.max_seq_len)
        lg, cache = JM.prefill(jcfg, p, tk[:, :t], cache)
        out = [lg]
        for i in range(n_dec):
            lg, cache = JM.decode_step(jcfg, p, tk[:, t + i],
                                       jnp.full((b,), t + i, jnp.int32), cache)
            out.append(lg)
        return jnp.stack(out)

    return np.asarray((jax.jit(run) if jit else run)(jparams, toks))


def _run_port(cfg, params, toks, n_dec):
    b, t = toks.shape[0], toks.shape[1] - n_dec
    tk = torch.from_numpy(np.array(toks)).to(torch.int32)
    cache = TM.init_kv_cache(cfg, b, max_len=cfg.max_seq_len, device=CPU)
    lg, cache = TM.prefill(cfg, params, tk[:, :t], cache)
    out = [lg]
    for i in range(n_dec):
        lg, cache = TM.decode_step(cfg, params, tk[:, t + i],
                                   torch.full((b,), t + i, dtype=torch.int32),
                                   cache)
        out.append(lg)
    return torch.stack(out).numpy()


def _check_logits(got, want):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= LOGIT_TOL, err
    # the argmax may only differ where the reference's top-2 is a near tie
    top2 = np.sort(want, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > 0.02
    assert (got.argmax(-1) == want.argmax(-1))[decisive].all()


@pytest.mark.parametrize("which", ["kernel_shapes", "tiny"])
def test_prefill_and_decode_match_jax(which):
    jcfg = (JM.LlamaConfig(**KCFG) if which == "kernel_shapes"
            else JM.LlamaConfig.tiny())
    jparams, cfg, params = _setup(jcfg, SEED)
    rng = np.random.default_rng(SEED)
    toks = jnp.asarray(rng.integers(1, cfg.vocab_size, (2, 128 + 3)), jnp.int32)
    launches = (TQ.w4_gemv.launches, TDA.decode_attn2.launches,
                TF.flash_attn.launches)
    got = _run_port(cfg, params, toks, 3)
    want = _run_jax(jcfg, jparams, toks, 3, jit=True)
    _check_logits(got, want)
    assert launches == (TQ.w4_gemv.launches, TDA.decode_attn2.launches,
                        TF.flash_attn.launches)   # CPU: no kernel launched


@pytest.mark.heavy_interpret
def test_prefill_and_decode_match_jax_kernels(monkeypatch):
    """The same comparison with the JAX package forced onto its own Pallas
    kernels (interpret mode): decode_attn2 and the native flash kernel."""
    monkeypatch.setenv("PIQUANT_ATTN2", "force")
    monkeypatch.setenv("PIQUANT_FLASH", "force")
    monkeypatch.setenv("PIQUANT_FLASH_IMPL", "native")
    jcfg = JM.LlamaConfig(**KCFG)
    jparams, cfg, params = _setup(jcfg, SEED + 1)
    rng = np.random.default_rng(SEED + 1)
    toks = jnp.asarray(rng.integers(1, cfg.vocab_size, (2, 128 + 3)), jnp.int32)
    with jax.enable_x64(False):
        want = _run_jax(jcfg, jparams, toks, 3, jit=True)
    _check_logits(_run_port(cfg, params, toks, 3), want)


@pytest.mark.parametrize("quantize_lm_head", [False, True])
def test_quantize_params_bit_exact(quantize_lm_head):
    """The JAX float init carried across, then quantized by each package:
    every quantized leaf bit-exact; the port's own init has the JAX tree's
    keys, shapes and dtypes."""
    jcfg = JM.LlamaConfig(**KCFG)
    jfloat = JM.init_params(jcfg, jax.random.key(SEED))
    jq = JM.quantize_params(jfloat, bits=4, quantize_lm_head=quantize_lm_head)
    tq = TM.quantize_params(convert.params_from_jax(jfloat, device=CPU), 4,
                            quantize_lm_head=quantize_lm_head)
    pairs = [(jq["lm_head"], tq["lm_head"])] + [
        (jl[k], tl[k]) for jl, tl in zip(jq["layers"], tq["layers"])
        for k in ("wq", "wk", "wv", "wo", "w1", "w2", "w3")]
    for j, t in pairs:
        if not quantize_lm_head and j is jq["lm_head"]:
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(j, np.float32))
            continue
        assert (t.bits, t.k) == (j.bits, j.k)
        for f in ("data", "scale", "zero_point"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)))
    tinit = TM.init_params(convert.config_from_jax(jcfg), seed=SEED,
                           device=CPU)
    jflat = jax.tree_util.tree_flatten_with_path(jfloat)[0]
    tflat = jax.tree_util.tree_flatten_with_path(tinit)[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (_, j), (_, t) in zip(jflat, tflat):
        assert tuple(t.shape) == j.shape and t.dtype == torch.bfloat16


def test_decode_from_jax_cache():
    """A cache filled by the JAX prefill, carried across with
    kv_cache_from_jax: the port's decode step from it matches the JAX one."""
    jcfg = JM.LlamaConfig(**KCFG)
    jparams, cfg, params = _setup(jcfg, SEED + 2)
    rng = np.random.default_rng(SEED + 2)
    toks = jnp.asarray(rng.integers(1, cfg.vocab_size, (2, 129)), jnp.int32)
    jcache = JM.init_kv_cache(jcfg, 2, max_len=jcfg.max_seq_len)
    _, jcache = JM.prefill(jcfg, jparams, toks[:, :128], jcache)
    pos = np.full((2,), 128, np.int32)
    want, jcache = JM.decode_step(jcfg, jparams, toks[:, 128],
                                  jnp.asarray(pos), jcache)
    cache = convert.kv_cache_from_jax(jcache, device=CPU)
    got, _ = TM.decode_step(cfg, params, torch.from_numpy(np.array(toks[:, 128])),
                            torch.from_numpy(pos), cache)
    _check_logits(got.numpy(), np.asarray(want))


def test_config_from_jax_refuses_family_flags():
    # GPT-OSS's flags carry across since they were ported; expert
    # parallelism still raises
    assert convert.config_from_jax(JM.LlamaConfig.gpt_oss_20b()) == (
        TM.LlamaConfig.gpt_oss_20b())
    with pytest.raises(NotImplementedError, match="ep_axis"):
        convert.config_from_jax(dataclasses.replace(
            JM.LlamaConfig.gpt_oss_20b(), ep_axis="ep"))
    # kv_bits=4 carries across
    kv4 = convert.config_from_jax(JM.LlamaConfig.tiny(kv_bits=4))
    assert kv4 == TM.LlamaConfig.tiny(kv_bits=4) and kv4.kv_bits == 4
    cfg = convert.config_from_jax(JM.LlamaConfig.llama3_8b())
    assert cfg == TM.LlamaConfig.llama3_8b()
    assert (cfg.vocab_size, cfg.d_model, cfg.n_layers, cfg.n_heads,
            cfg.n_kv_heads, cfg.d_ff, cfg.head_dim) == (
        128256, 4096, 32, 32, 8, 14336, 128)


def test_llama3_rope_scaling_matches_jax():
    rope = JM.Llama3Rope(factor=8.0)
    jcfg = JM.LlamaConfig(**KCFG, llama3_rope=rope)
    cfg = convert.config_from_jax(jcfg)
    pos = np.arange(0, 9000, 37, dtype=np.int32)[None]
    jc, js = JM._rope_freqs(jcfg, jnp.asarray(pos))
    tc, ts = TM._rope_freqs(cfg, torch.from_numpy(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-3)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-3)


def test_random_quantized_params_shapes():
    cfg = TM.LlamaConfig(**KCFG)
    p = TM.random_quantized_params(cfg, seed=3, device="cpu")
    wq = p["layers"][0]["wq"]
    assert wq.data.shape == (128, 256) and wq.data.dtype == torch.uint8
    assert wq.zero_point.flatten()[0] == 8 and wq.bits == 4
    assert p["lm_head"].dtype == torch.bfloat16
    cache = TM.init_kv_cache(cfg, 2, device="cpu")
    logits, _ = TM.prefill(cfg, p, torch.ones((2, 8), dtype=torch.int32),
                           cache)
    assert logits.shape == (2, 256) and torch.isfinite(logits).all()


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TM.LlamaConfig(**KCFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_kv_cache(cfg, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.random_quantized_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_jax({"embed": np.zeros((2, 2), np.float32)})


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import piquant_tpu_torch as P\n"
        "for m in pkgutil.walk_packages(P.__path__, 'piquant_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'piquant_tpu' or m.startswith('piquant_tpu.'))\n"
        "n = sum(m.startswith('piquant_tpu_torch') for m in sys.modules)\n"
        "print(n, bad)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                         capture_output=True, text=True).stdout.split(None, 1)
    assert int(out[0]) >= 15, out
    assert out[1].strip() == "[]", out
