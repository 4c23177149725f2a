"""Fused projections, the fused MLP and first flash-decode kernels' plain
versions, `forward` against the cache (chunked prefill, caller masks,
attention windows, the non-deferred path), the scattered cache append and
the rest of the engine (chunked admission, the prefix cache, attention
window buckets, snapshot / restore), on the CPU, against the JAX package.
Inputs are drawn with numpy from a seed and handed to both packages."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from piquant_tpu.models import llama as JM
from piquant_tpu.ops.pallas import qmatmul as JQ
from piquant_tpu.ops.pallas.attention import decode_attention as j_decode_attention
from piquant_tpu.quant import kv_cache as JKV
from piquant_tpu.quant.linear import quantize_linear_weight as j_qlw
from piquant_tpu_torch import convert
from piquant_tpu_torch.models import llama as TM
from piquant_tpu_torch.ops.cuda import attention as TA
from piquant_tpu_torch.ops.cuda import decode_attn2 as TDA
from piquant_tpu_torch.ops.cuda import qmatmul as TQ
from piquant_tpu_torch.quant import kv_cache as TKV
from piquant_tpu_torch.serving import (Engine, EngineConfig, Request,
                                       SamplingParams)
from tests.token_guard import assert_tokens_match_guarded

SEED = 0xF05E
CPU = torch.device("cpu")
# head_dim 128 and d_ff 512: every kernel gate of this slice takes the tiny
# model (the fused MLP's block sizes, decode_attention's S % 8)
KCFG = dict(vocab_size=256, d_model=256, n_layers=2, n_heads=2, n_kv_heads=1,
            d_ff=512, max_seq_len=64)
# whole-model logits, as tests/test_torch_model.py: max |port - jax| <=
# 1.5e-2 max |jax|
LOGIT_TOL = 1.5e-2
# the plain versions against the Pallas kernels in interpret mode: the same
# arithmetic in another summation order (measured <= 5.5e-6 on values of
# 1-8)
KERNEL_TOL = dict(atol=1e-4, rtol=1e-4)
# the fused MLP: besides, XLA's and torch's exp / tanh differ in the last
# bits, which may flip one bf16 rounding of h and move y by one h ulp times
# a w2 value (1.5e-4 seen on values of 1-5; the reference's own test holds
# 2e-2 of the largest value)
MLP_TOL = dict(atol=2e-3, rtol=1e-4)
SWITCHES = ("PIQUANT_MLP_FUSE", "PIQUANT_DEFER_APPEND",
            "PIQUANT_TPU_PALLAS_ATTN")


def _t(a):
    return convert.tensor_from_numpy(a, CPU)


@pytest.fixture(autouse=True)
def _switches_off(monkeypatch):
    """Every test starts from the reference's defaults of the switches, on
    one intra-op thread (the tiny model's small ops stall on a thread pool
    whose cores the other test workers hold)."""
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _switched(monkeypatch, fuse="1", defer="0", pallas="1"):
    monkeypatch.setenv("PIQUANT_MLP_FUSE", fuse)
    monkeypatch.setenv("PIQUANT_DEFER_APPEND", defer)
    monkeypatch.setenv("PIQUANT_TPU_PALLAS_ATTN", pallas)


@pytest.fixture(scope="module")
def tiny():
    jcfg = JM.LlamaConfig(**KCFG)
    jparams = JM.quantize_params(JM.init_params(jcfg, jax.random.key(SEED)),
                                 bits=4)
    return (jcfg, jparams, convert.config_from_jax(jcfg),
            convert.params_from_jax(jparams, device=CPU))


# ---------------------------------------------------------------------------
# mlp_fused: the plain version against the Pallas kernel, and the gates
# ---------------------------------------------------------------------------

def _mlp_weights(rng, k, i_ff, n):
    w1, w3 = (jnp.asarray(rng.normal(0, 0.05, (k, i_ff)), jnp.float32)
              for _ in range(2))
    w2 = jnp.asarray(rng.normal(0, 0.05, (i_ff, n)), jnp.float32)
    return (JM._concat_qlinear([j_qlw(w1, 4), j_qlw(w3, 4)]), j_qlw(w2, 4))


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("m", [8, 3])
def test_mlp_fused_plain_matches_pallas(monkeypatch, act, m):
    """At f32 output, where the reference's output-dtype accumulation is
    the port's f32 one; the zero points are not all 8, so a dropped fold
    shows."""
    rng = np.random.default_rng(SEED + m)
    k, i_ff, n = 512, 1024, 512
    q13, q2 = _mlp_weights(rng, k, i_ff, n)
    assert len(set(np.asarray(q2.zero_point).ravel().tolist())) > 2
    x = jnp.asarray(rng.normal(0, 1, (m, k)), jnp.bfloat16)
    monkeypatch.setenv("PIQUANT_MLP_FUSE", "1")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JQ.mlp_fused_matmul(x, q13, q2, act, jnp.float32))
    got = TQ.mlp_fused_matmul(_t(x), convert.params_from_jax(q13, device=CPU),
                              convert.params_from_jax(q2, device=CPU), act,
                              torch.float32)
    np.testing.assert_allclose(got.numpy(), want, **MLP_TOL)
    # bf16 output: the port's f32 sum rounded once, the plain version's
    got16 = TQ.mlp_fused_matmul(_t(x), convert.params_from_jax(q13, device=CPU),
                                convert.params_from_jax(q2, device=CPU), act,
                                torch.bfloat16)
    np.testing.assert_array_equal(got16.float().numpy(),
                                  got.to(torch.bfloat16).float().numpy())


# (K, I, N, M, weight formats, switch) each a decline of the reference's
# gate (`qmatmul.py:1340-1370`)
MLP_DECLINES = {
    "switch off": (512, 1024, 512, 8, (4, None), (4, None), "0"),
    "grouped w13": (512, 1024, 512, 8, (4, 32), (4, None), "1"),
    "int8 w2": (512, 1024, 512, 8, (4, None), (8, None), "1"),
    "int2 w13": (512, 1024, 512, 8, (2, None), (4, None), "1"),
    "m over M_MAX": (512, 1024, 512, 65, (4, None), (4, None), "1"),
    "no bkh for I/2": (512, 768, 512, 8, (4, None), (4, None), "1"),
    "no bnb for N": (512, 1024, 384, 8, (4, None), (4, None), "1"),
    "k % 256": (384, 1024, 512, 8, (4, None), (4, None), "1"),
    "no bna for I": (512, 1408, 512, 8, (4, None), (4, None), "1"),
}


@pytest.mark.parametrize("case", list(MLP_DECLINES))
def test_mlp_fused_gates(monkeypatch, case):
    k, i_ff, n, m, f13, f2, switch = MLP_DECLINES[case]
    rng = np.random.default_rng(SEED)
    w1, w3 = (jnp.asarray(rng.normal(0, 0.05, (k, i_ff)), jnp.float32)
              for _ in range(2))
    w2 = jnp.asarray(rng.normal(0, 0.05, (i_ff, n)), jnp.float32)
    q13 = JM._concat_qlinear([j_qlw(w1, f13[0], group_size=f13[1]),
                              j_qlw(w3, f13[0], group_size=f13[1])])
    q2 = j_qlw(w2, f2[0], group_size=f2[1])
    x = jnp.asarray(rng.normal(0, 1, (m, k)), jnp.bfloat16)
    monkeypatch.setenv("PIQUANT_MLP_FUSE", switch)
    assert JQ.mlp_fused_matmul(x, q13, q2, "silu", jnp.float32) is None
    assert TQ.mlp_fused_matmul(_t(x), convert.params_from_jax(q13, device=CPU),
                               convert.params_from_jax(q2, device=CPU),
                               "silu", torch.float32) is None


def test_mlp_fused_gates_nf4_and_chain(monkeypatch):
    """NF4 weights and weights whose K do not chain decline too."""
    monkeypatch.setenv("PIQUANT_MLP_FUSE", "1")
    rng = np.random.default_rng(SEED + 1)
    q13, q2 = _mlp_weights(rng, 512, 1024, 512)
    t13, t2 = (convert.params_from_jax(q, device=CPU) for q in (q13, q2))
    x = torch.randn(8, 512).to(torch.bfloat16)
    assert TQ.mlp_fused_matmul(x, t13, t2, "silu") is not None
    nf4 = dataclasses.replace(t2, codebook="nf4")
    assert TQ.mlp_fused_matmul(x, t13, nf4, "silu") is None
    assert TQ.mlp_fused_matmul(x, t13, t13, "silu") is None     # w2.k != I
    assert TQ.mlp_fused_matmul(x[:, :256], t13, t2, "silu") is None


# ---------------------------------------------------------------------------
# decode_attn: the plain version against the Pallas kernel, and the gates
# ---------------------------------------------------------------------------

def _v1_inputs(rng, b, hkv, rep, s, d):
    return (rng.normal(0, 1, (b, hkv, rep, d)).astype(np.float32),
            rng.integers(-127, 128, (b, hkv, s, d)).astype(np.int8),
            rng.uniform(0.001, 0.02, (b, hkv, s, 1)).astype(np.float32),
            rng.integers(-127, 128, (b, hkv, s, d)).astype(np.int8),
            rng.uniform(0.001, 0.02, (b, hkv, s, 1)).astype(np.float32))


# tests/test_attention_kernel.py's cases, the first position, head_dim
# 256, S below one chunk and three chunks, one chunk wholly past pos
@pytest.mark.parametrize("b,hkv,rep,s,d,pos", [
    (2, 4, 2, 64, 128, None), (1, 2, 4, 256, 128, None),
    (1, 2, 2, 64, 128, (0,)), (2, 2, 2, 512, 256, (0, 511)),
    (2, 1, 8, 384, 128, (383, 7)), (2, 2, 3, 1536, 128, (700, 1535))])
def test_decode_attn_plain_matches_pallas(b, hkv, rep, s, d, pos):
    rng = np.random.default_rng(SEED + s + d)
    q, kc, ks, vc, vs = _v1_inputs(rng, b, hkv, rep, s, d)
    positions = (rng.integers(0, s, (b,)) if pos is None
                 else np.array(pos)).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_decode_attention(
            *(jnp.asarray(a) for a in (q, kc, ks, vc, vs, positions)),
            d ** -0.5))
    got = TA.decode_attention(*(_t(a) for a in (q, kc, ks, vc, vs,
                                                positions)), d ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)


@pytest.mark.parametrize("s,d", [(100, 128), (1000, 128), (64, 64)])
def test_decode_attention_declines(s, d):
    """head_dim % 128, S % 8 and S % min(512, S) decline, as the
    reference's gate."""
    rng = np.random.default_rng(SEED)
    args = _v1_inputs(rng, 1, 1, 2, s, d) + (np.zeros(1, np.int32),)
    assert j_decode_attention(*(jnp.asarray(a) for a in args), 0.1) is None
    assert TA.decode_attention(*(_t(a) for a in args), 0.1) is None


# ---------------------------------------------------------------------------
# fused projections
# ---------------------------------------------------------------------------

def _same_tree(got, want):
    """The port's params against the JAX package's carried across, leaf for
    leaf and byte for byte."""
    assert set(got) == set(want)
    for name, a in got.items():
        b = want[name]
        if isinstance(a, int):
            assert a == b, name
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a, b), name
        else:
            for f in dataclasses.fields(a):
                x, y = getattr(a, f.name), getattr(b, f.name)
                if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
                    assert torch.equal(x, y), (name, f.name)
                else:
                    assert x == y, (name, f.name)


@pytest.mark.parametrize("fmt", [dict(bits=4), dict(bits=4, group_size=32),
                                 dict(bits=2, group_size=32),
                                 dict(bits="nf4"), dict(bits=8)])
def test_fuse_layer_projections_byte_equal(fmt):
    jcfg = JM.LlamaConfig(**KCFG)
    jparams = JM.quantize_params(JM.init_params(jcfg, jax.random.key(SEED)),
                                 **fmt)
    cfg = convert.config_from_jax(jcfg)
    got = TM.fuse_layer_projections(
        convert.params_from_jax(jparams, device=CPU), cfg)
    want = convert.params_from_jax(JM.fuse_layer_projections(jparams, jcfg),
                                   device=CPU)
    for lg, lw in zip(got["layers"], want["layers"]):
        assert {"wqkv", "w13"} <= set(lg) and not {"wq", "w1"} & set(lg)
        assert lg["fused_tp"] == 1
        _same_tree(lg, lw)


def test_fuse_moe_and_bias_layers():
    """An MoE layer fuses only wqkv; qkv_bias models stay unfused; tp > 1
    is tensor parallelism, not ported."""
    jcfg = JM.LlamaConfig(**{**KCFG, "n_experts": 4, "moe_top_k": 2,
                             "moe_d_ff": 256})
    jparams = JM.quantize_params(JM.init_params(jcfg, jax.random.key(SEED)),
                                 bits=4)
    cfg = convert.config_from_jax(jcfg)
    got = TM.fuse_layer_projections(
        convert.params_from_jax(jparams, device=CPU), cfg)
    want = convert.params_from_jax(JM.fuse_layer_projections(jparams, jcfg),
                                   device=CPU)
    for lg, lw in zip(got["layers"], want["layers"]):
        assert "wqkv" in lg and "w13" not in lg and "moe_w1" in lg
        _same_tree(lg, lw)
    bcfg = dataclasses.replace(cfg, qkv_bias=True)
    params = convert.params_from_jax(jparams, device=CPU)
    assert TM.fuse_layer_projections(params, bcfg) is params
    with pytest.raises(NotImplementedError, match="item 16"):
        TM.fuse_layer_projections(params, cfg, tp=2)


def _port_steps(cfg, params, toks, n_dec):
    b, t = toks.shape[0], toks.shape[1] - n_dec
    tk = _t(toks).to(torch.int32)
    cache = TM.init_kv_cache(cfg, b, max_len=cfg.max_seq_len, device=CPU)
    lg, cache = TM.prefill(cfg, params, tk[:, :t], cache)
    out = [lg]
    for i in range(n_dec):
        lg, cache = TM.decode_step(cfg, params, tk[:, t + i],
                                   torch.full((b,), t + i, dtype=torch.int32),
                                   cache)
        out.append(lg)
    return torch.stack(out).numpy()


def _jax_steps(jcfg, jparams, toks, n_dec):
    b, t = toks.shape[0], toks.shape[1] - n_dec
    cache = JM.init_kv_cache(jcfg, b, max_len=jcfg.max_seq_len)
    lg, cache = JM.prefill(jcfg, jparams, jnp.asarray(toks[:, :t]), cache)
    out = [lg]
    for i in range(n_dec):
        lg, cache = JM.decode_step(jcfg, jparams, jnp.asarray(toks[:, t + i]),
                                   jnp.full((b,), t + i, jnp.int32), cache)
        out.append(lg)
    return np.asarray(jnp.stack(out))


def _close(got, want, tol=LOGIT_TOL):
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


@pytest.mark.parametrize("switched", [False, True])
def test_fused_model_logits(tiny, monkeypatch, switched):
    """The fused tiny model: fused against unfused in the port, and against
    the JAX package's fused model (the same switches set for both; on the
    CPU the reference's two kernel routes need a TPU, so JAX runs the
    plain w13 and materialized paths there)."""
    jcfg, jparams, cfg, params = tiny
    toks = np.random.default_rng(SEED + 5).integers(1, 256, (2, 12)).astype(
        np.int32)
    fused = TM.fuse_layer_projections(params, cfg)
    unfused = _port_steps(cfg, params, toks, 3)
    if switched:
        _switched(monkeypatch)
    got = _port_steps(cfg, fused, toks, 3)
    _close(got, unfused)
    want = _jax_steps(jcfg, JM.fuse_layer_projections(jparams, jcfg), toks, 3)
    _close(got, want)


def test_fused_switches_route_the_kernels(tiny, monkeypatch):
    """Under the three switches a decode step takes the fused MLP and the
    first flash-decode kernel in every layer (their plain versions here)
    and decode_attn2 never; switched off, neither."""
    _, _, cfg, params = tiny
    fused = TM.fuse_layer_projections(params, cfg)
    calls = {"mlp": 0, "v1": 0, "v2": 0}
    for mod, name, key in ((TQ, "mlp_fused_plain", "mlp"),
                           (TA, "decode_attn_plain", "v1"),
                           (TDA, "decode_attn2_plain", "v2")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _key=key):
            calls[_key] += 1
            return _real(*a)
        monkeypatch.setattr(mod, name, spy)
    def step():
        cache = TM.init_kv_cache(cfg, 2, device=CPU)
        TM.prefill(cfg, fused, torch.ones((2, 9), dtype=torch.int32), cache)
        calls.update(mlp=0, v1=0, v2=0)
        TM.decode_step(cfg, fused, torch.ones(2, dtype=torch.int32),
                       torch.full((2,), 9, dtype=torch.int32), cache)
        return dict(calls)

    assert step() == {"mlp": 0, "v1": 0, "v2": cfg.n_layers}
    _switched(monkeypatch)
    assert step() == {"mlp": cfg.n_layers, "v1": cfg.n_layers, "v2": 0}


def test_v1_route_runs_wo_without_act_quant(tiny, monkeypatch):
    """On the reference's v1 route wo runs without int8 activations (and
    bo is not added), whatever act_quant_decode says; the fused MLP
    declines under act-quant."""
    _, _, cfg, params = tiny
    acfg = dataclasses.replace(cfg, act_quant_decode=True)
    fused = TM.fuse_layer_projections(params, acfg)
    seen = []
    real = TM.quantized_matmul

    def spy(x, w, out_dtype, act_quant=False):
        seen.append((w.n, bool(act_quant)))
        return real(x, w, out_dtype, act_quant=act_quant)

    monkeypatch.setattr(TM, "quantized_matmul", spy)
    _switched(monkeypatch)
    cache = TM.init_kv_cache(acfg, 1, device=CPU)
    TM.prefill(acfg, fused, torch.tensor([[3, 4, 5, 6]]), cache)
    seen.clear()
    TM.decode_step(acfg, fused, torch.tensor([7]), torch.tensor([4]), cache)
    # per layer: wqkv and w13 / w2 with int8 activations (the fused MLP
    # declines under act-quant), wo without (the lm_head is float)
    d = acfg.d_model
    assert seen == [(2 * d, True), (d, False), (2 * acfg.d_ff, True),
                    (d, True)] * acfg.n_layers


# ---------------------------------------------------------------------------
# forward against the cache
# ---------------------------------------------------------------------------

def _chunked(model, cfg, params, prompt, c, make_cache, mask=None):
    """Chunks of c tokens against the cache (the last one padded), the
    final chunk's logits at the prompt's last token."""
    padded = list(prompt) + [0] * (-len(prompt) % c)
    cache = make_cache()
    last = None
    for s in range(0, len(padded), c):
        final = s + c >= len(padded)
        lp = len(prompt) - 1 - s if final else 0
        pos = np.arange(s, s + c, dtype=np.int32)[None]
        kw = {} if mask is None else {"mask": mask(s, c)}
        if model is TM:
            lg, cache = TM.forward(cfg, params, torch.tensor([padded[s:s + c]]),
                                   positions=_t(pos), cache=cache,
                                   logit_positions=torch.tensor([lp]),
                                   kv_write_start=s, **kw)
        else:
            lg, cache = JM.forward(cfg, params, jnp.asarray([padded[s:s + c]]),
                                   positions=jnp.asarray(pos), cache=cache,
                                   logit_positions=jnp.asarray([lp]),
                                   kv_write_start=jnp.int32(s), **kw)
        last = np.asarray(lg[:, 0], np.float32)
    return last, cache


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_chunked_forward_matches_jax(tiny, kv_bits):
    """T > 1 against the cache with kv_write_start (the reference's
    chunked prefill), logits and cache lengths against JAX; at kv8 the
    chunked logits within the reference's 5% of a one-shot prefill (the
    chunks read back quantized K/V: kv4's codes move them further)."""
    jcfg, jparams, cfg, params = tiny
    jcfg = dataclasses.replace(jcfg, kv_bits=kv_bits)
    cfg = dataclasses.replace(cfg, kv_bits=kv_bits)
    prompt = [int(t) for t in np.random.default_rng(SEED + 9).integers(
        1, 256, 13)]
    got, tc = _chunked(TM, cfg, params, prompt, 4,
                       lambda: TM.init_kv_cache(cfg, 1, device=CPU))
    want, jc = _chunked(JM, jcfg, jparams, prompt, 4,
                        lambda: JM.init_kv_cache(jcfg, 1))
    _close(got, want)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    if kv_bits == 8:
        one, _ = TM.prefill(cfg, params, torch.tensor([prompt]),
                            TM.init_kv_cache(cfg, 1, device=CPU))
        _close(got, one.numpy(), 0.05)


def test_caller_mask_matches_jax(tiny):
    """A caller mask at T > 1 against the cache and at T = 1 (which turns
    deferral off): the default causal mask handed in gives JAX's logits."""
    jcfg, jparams, cfg, params = tiny
    prompt = [5, 9, 2, 7, 1, 8, 3, 6]
    s_len = cfg.max_seq_len

    def mask(s, c):
        qp = np.arange(s, s + c)[:, None]
        return np.where(np.arange(s_len)[None] <= qp, 0.0, -1e9).astype(
            np.float32)[None, None]

    got, tc = _chunked(TM, cfg, params, prompt, 4,
                       lambda: TM.init_kv_cache(cfg, 1, device=CPU),
                       mask=lambda s, c: _t(mask(s, c)))
    want, jc = _chunked(JM, jcfg, jparams, prompt, 4,
                        lambda: JM.init_kv_cache(jcfg, 1),
                        mask=lambda s, c: jnp.asarray(mask(s, c)))
    _close(got, want)
    m1 = mask(len(prompt), 1)
    lt, _ = TM.forward(cfg, params, torch.tensor([[4]]),
                       positions=torch.tensor([[len(prompt)]]), cache=tc,
                       mask=_t(m1))
    lj, _ = JM.forward(jcfg, jparams, jnp.asarray([[4]]),
                       positions=jnp.asarray([[len(prompt)]]), cache=jc,
                       mask=jnp.asarray(m1))
    _close(lt.numpy(), np.asarray(lj))


@pytest.mark.parametrize("defer", ["1", "0"])
def test_attn_window_matches_jax(tiny, monkeypatch, defer):
    """attn_window: decode over the cache's first 32 positions (every
    position lies below it), deferred and not, against JAX with the same
    switch and window."""
    jcfg, jparams, cfg, params = tiny
    monkeypatch.setenv("PIQUANT_DEFER_APPEND", defer)
    b, t = 2, 10
    toks = np.random.default_rng(SEED + 3).integers(1, 256, (b, t + 3))
    tc = TM.init_kv_cache(cfg, b, device=CPU)
    _, tc = TM.prefill(cfg, params, _t(toks[:, :t]).int(), tc)
    jc = JM.init_kv_cache(jcfg, b)
    _, jc = JM.prefill(jcfg, jparams, jnp.asarray(toks[:, :t], jnp.int32), jc)
    for i in range(3):
        pos = np.full((b,), t + i, np.int32)
        lt, tc = TM.decode_step(cfg, params, _t(toks[:, t + i]).int(), _t(pos),
                                tc, attn_window=32)
        lj, jc = JM.decode_step(jcfg, jparams,
                                jnp.asarray(toks[:, t + i], jnp.int32),
                                jnp.asarray(pos), jc, attn_window=32)
        _close(lt.numpy(), np.asarray(lj))


def test_defer_switch_matches_deferred_and_jax(tiny, monkeypatch):
    """PIQUANT_DEFER_APPEND=0 (append first, attend over the cache) against
    the deferred path and against JAX under the same switch."""
    jcfg, jparams, cfg, params = tiny
    toks = np.random.default_rng(SEED + 4).integers(1, 256, (2, 14)).astype(
        np.int32)
    deferred = _port_steps(cfg, params, toks, 4)
    monkeypatch.setenv("PIQUANT_DEFER_APPEND", "0")
    got = _port_steps(cfg, params, toks, 4)
    _close(got, deferred)
    _close(got, _jax_steps(jcfg, jparams, toks, 4))


def test_v1_route_matches_jax_non_deferred(tiny, monkeypatch):
    """With PIQUANT_TPU_PALLAS_ATTN=1 on the non-deferred path the port
    takes the first flash-decode kernel (its plain version here); JAX on
    the CPU runs its materialized path, the same function."""
    jcfg, jparams, cfg, params = tiny
    toks = np.random.default_rng(SEED + 6).integers(1, 256, (2, 11)).astype(
        np.int32)
    _switched(monkeypatch, fuse="0")
    _close(_port_steps(cfg, params, toks, 3),
           _jax_steps(jcfg, jparams, toks, 3))


# ---------------------------------------------------------------------------
# the scattered stacked append
# ---------------------------------------------------------------------------

NL, B, H, S, D = 2, 2, 2, 32, 16


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", ["decode", "decode_past_end", "chunk_even",
                                  "chunk_odd", "chunk_odd_len",
                                  "scattered_rows"])
def test_stacked_append_byte_equal(bits, case):
    rng = np.random.default_rng(SEED + bits)
    one_j = JKV.kv_cache_init(B, H, S, D, bits=bits)
    one_t = TKV.kv_cache_init(B, H, S, D, bits=bits, device=CPU)
    jc = jax.tree.map(lambda a: jnp.stack([a] * NL), one_j)
    tc = TKV.KVCache(*(torch.stack([a] * NL) for a in one_t.tensors()))

    def append(layer, pos, start=None):
        pos = np.asarray(pos, np.int32)
        t = pos.shape[1]
        k = rng.normal(0, 1, (B, H, t, D)).astype(np.float32)
        v = rng.normal(0, 1, (B, H, t, D)).astype(np.float32)
        nonlocal jc
        jc = JKV.kv_cache_append_stacked(
            jc, layer, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
            contiguous_start=None if start is None else jnp.int32(start))
        TKV.kv_cache_append_stacked(tc, layer, _t(k), _t(v), _t(pos),
                                    contiguous_start=start)

    for layer in range(NL):     # every pair row holds two positions first
        append(layer, np.broadcast_to(np.arange(S), (B, S)), 0)
    if case == "decode":
        append(1, [[12], [31]])
    elif case == "decode_past_end":
        append(0, [[32], [7]])
    elif case == "scattered_rows":
        append(1, [[3, 9, 20], [31, 0, 33]])
    else:
        start, t = {"chunk_even": (4, 8), "chunk_odd": (7, 8),
                    "chunk_odd_len": (6, 5)}[case]
        append(1, np.broadcast_to(np.arange(start, start + t), (B, t)), start)
    for f in ("k_codes", "v_codes", "k_scale", "v_scale", "length"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _single(cfg, params, prompt, n_new):
    """Single-request greedy generation: one-shot prefill, then decode."""
    cache = TM.init_kv_cache(cfg, 1, device=CPU)
    logits, cache = TM.prefill(cfg, params, torch.tensor([prompt]), cache)
    toks, pos = [], len(prompt)
    tok = int(logits.argmax(-1)[0])
    for _ in range(n_new):
        toks.append(tok)
        logits, cache = TM.decode_step(cfg, params, torch.tensor([tok]),
                                       torch.tensor([pos]), cache)
        tok = int(logits.argmax(-1)[0])
        pos += 1
    return toks


def _fwd(cfg, params):
    def fwd(toks):
        return TM.forward(cfg, params, torch.from_numpy(np.array(toks)))[0]
    return fwd


def _engine(cfg, params, prompts, n_new, preseed=None, **ec):
    eng = Engine(cfg, params, EngineConfig(**ec), device=CPU)
    if preseed is not None:
        eng.preseed_prefix(preseed)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=list(p),
                           sampling=SamplingParams(max_new_tokens=n_new)))
    return sorted(eng.run(), key=lambda r: r.rid), eng


def test_chunked_prefill_engine(tiny):
    """Deterministic, every request complete, tokens against single-request
    generation (tests/test_serving.py:103)."""
    _, _, cfg, params = tiny
    prompts = [[1, 2, 3, 4, 5, 6, 7], [9, 8, 7, 6, 5], [4, 4, 4]]
    ec = dict(batch_slots=2, max_seq_len=64, prefill_pad=4, prefill_chunk=4)
    a, _ = _engine(cfg, params, prompts, 5, **ec)
    b, _ = _engine(cfg, params, prompts, 5, **ec)
    for ra, rb, p in zip(a, b, prompts):
        assert len(ra.tokens) == 5 and ra.tokens == rb.tokens
        assert_tokens_match_guarded(_fwd(cfg, params), p, ra.tokens,
                                    _single(cfg, params, p, 5))


def test_chunked_prefill_near_capacity(tiny):
    """The final chunk is shifted back to end at max_seq_len
    (tests/test_serving.py:145)."""
    _, _, cfg, params = tiny
    prompts = [list(range(1, 20)), list(range(30, 47))]
    got, _ = _engine(cfg, params, prompts, 4, batch_slots=2, max_seq_len=24,
                     prefill_chunk=8)
    want, _ = _engine(cfg, params, prompts, 4, batch_slots=2, max_seq_len=64,
                      prefill_chunk=8)
    assert [r.tokens for r in got] == [r.tokens for r in want]


@pytest.mark.parametrize("switched", [False, True])
def test_engine_attn_window_buckets(tiny, monkeypatch, switched):
    """Window buckets do not change greedy output (tests/test_serving.py:
    338), on the default route and on the fused, switched one."""
    _, _, cfg, params = tiny
    if switched:
        params = TM.fuse_layer_projections(params, cfg)
        _switched(monkeypatch)
    rng = np.random.default_rng(SEED + 20)
    prompts = [[int(t) for t in rng.integers(1, 256, 7)] for _ in range(2)]
    done, _ = _engine(cfg, params, prompts, 5, batch_slots=2,
                      max_seq_len=64, attn_windows=(16, 32, 64),
                      decode_block=4)
    for p, r in zip(prompts, done):
        assert_tokens_match_guarded(_fwd(cfg, params), p, r.tokens,
                                    _single(cfg, params, p, 5))


def test_engine_window_bucket_choice(tiny, monkeypatch):
    """The smallest bucket covering the longest active context plus a
    block reaches forward as attn_window."""
    _, _, cfg, params = tiny
    seen = []
    real = TM.forward

    def spy(*a, attn_window=None, **kw):
        seen.append(attn_window)
        return real(*a, attn_window=attn_window, **kw)

    monkeypatch.setattr(TM, "forward", spy)
    _engine(cfg, params, [[1] * 9], 6, batch_slots=1, max_seq_len=64,
            attn_windows=(16, 32), decode_block=4)
    decode = [w for w in seen if w is not None]
    # 9 + 4 + 1 <= 16, then 13 + 4 + 1 > 16
    assert decode[:4] == [16] * 4 and decode[4:8] == [32] * 4


SYS = [7, 3, 9, 1, 5, 2, 8, 6]          # 8 = 2 whole chunks of 4


def _prefix_runs(cfg, params, prompts, n_new, **kw):
    ec = dict(batch_slots=2, max_seq_len=64, prefill_chunk=4)
    base, _ = _engine(cfg, params, prompts, n_new, **ec)
    got, eng = _engine(cfg, params, prompts, n_new, **ec, **kw)
    assert [r.tokens for r in got] == [r.tokens for r in base]
    return eng


def test_prefix_cache_preseed(tiny):
    _, _, cfg, params = tiny
    eng = _prefix_runs(cfg, params, [SYS + [11, 12, 13], SYS + [4], [9, 9, 9, 2]],
                       6, prefix_cache=4, preseed=SYS)
    assert (eng.metrics.prefix_hits, eng.metrics.prefix_tokens_saved) == (2, 16)


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_prefix_cache_exact_match(tiny, kv_bits):
    """Prompt == the pooled tokens: all but the last position reused, so
    the chunks restart at plen - 1 = 7, an odd start under kv4."""
    _, _, cfg, params = tiny
    cfg = dataclasses.replace(cfg, kv_bits=kv_bits)
    eng = _prefix_runs(cfg, params, [list(SYS)], 6, prefix_cache=2,
                       preseed=SYS)
    assert (eng.metrics.prefix_hits, eng.metrics.prefix_tokens_saved) == (1, 7)


def test_prefix_cache_auto_capture(tiny):
    _, _, cfg, params = tiny
    prompt = [5, 1, 4, 2, 8, 3, 7, 7, 2]
    eng = _prefix_runs(cfg, params, [list(prompt), list(prompt)], 5,
                       prefix_cache=2, prefix_cache_auto=True)
    assert eng.metrics.prefix_hits >= 1
    assert eng.metrics.prefix_tokens_saved >= 8


def test_prefix_cache_lru_and_config(tiny):
    _, _, cfg, params = tiny
    eng = Engine(cfg, params, EngineConfig(batch_slots=2, max_seq_len=64,
                                           prefill_chunk=4, prefix_cache=1),
                 device=CPU)
    eng.preseed_prefix([1, 2, 3, 4])
    eng.preseed_prefix([5, 6, 7, 8])            # capacity 1: evicts the first
    assert list(eng._prefix_pool) == [(0, (5, 6, 7, 8))]
    with pytest.raises(ValueError, match="prefill_chunk"):
        Engine(cfg, params, EngineConfig(batch_slots=2, max_seq_len=64,
                                         prefix_cache=2), device=CPU)
    with pytest.raises(ValueError, match="exceeds"):
        Engine(cfg, params, EngineConfig(max_seq_len=64, prefill_chunk=128),
               device=CPU)


def test_engine_snapshot_restore_identical(tiny, tmp_path):
    """Snapshot after two decode blocks, restore into a fresh engine,
    finish: every request's tokens equal an uninterrupted run's
    (tests/test_serving.py:775)."""
    _, _, cfg, params = tiny
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7], [4, 4, 4, 4]]

    def make(reqs=True):
        eng = Engine(cfg, params, EngineConfig(
            batch_slots=2, max_seq_len=64, decode_block=4, prefill_chunk=4,
            prefix_cache=2), device=CPU)
        if reqs:
            for i, p in enumerate(prompts):
                eng.submit(Request(rid=i, prompt=list(p),
                                   sampling=SamplingParams(max_new_tokens=8)))
        return eng

    want = {r.rid: r.tokens for r in make().run()}
    eng = make()
    eng._admit()
    eng._step_decode()
    eng._step_decode()
    path = str(tmp_path / "engine.pkl")
    eng.save(path)
    eng2 = make(reqs=False)
    eng2.load(path)
    assert {r.rid: r.tokens for r in eng2.run()} == want
    # an in-memory snapshot taken while run_stream has a block in flight:
    # the block is processed first, and the engine runs on unchanged
    eng3 = make()
    stream = eng3.run_stream()
    next(stream)
    assert eng3._inflight is not None
    state = eng3.snapshot()
    assert eng3._inflight is None
    for _ in stream:
        pass
    eng4 = make(reqs=False)
    eng4.restore(state)
    got = {r.rid: r.tokens for r in eng4.run()}
    assert got == want == {r.rid: r.tokens for r in eng3._all}


def test_engine_snapshot_rejects_mid_admission(tiny):
    _, _, cfg, params = tiny
    eng = Engine(cfg, params, EngineConfig(batch_slots=1, max_seq_len=64,
                                           prefill_chunk=4), device=CPU)
    eng.submit(Request(rid=0, prompt=list(range(1, 12)),
                       sampling=SamplingParams(max_new_tokens=2)))
    eng._admit(max_chunks=1)       # a chunked prefill left in flight
    with pytest.raises(ValueError, match="mid-admission"):
        eng.snapshot()


def test_fused_switched_engine_matches_single(tiny, monkeypatch):
    """The engine on the fused params under the three switches, chunked,
    with the prefix cache: tokens against the same route's single-request
    generation; every layer of a decode step through both kernels (the
    four-token chunks take the fused MLP too: M <= 64)."""
    _, _, cfg, params = tiny
    fused = TM.fuse_layer_projections(params, cfg)
    _switched(monkeypatch)
    calls = {"mlp": 0, "v1": 0}
    for mod, name, key in ((TQ, "mlp_fused_plain", "mlp"),
                           (TA, "decode_attn_plain", "v1")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _key=key):
            calls[_key] += 1
            return _real(*a)
        monkeypatch.setattr(mod, name, spy)
    prompts = [SYS + [11, 12, 13], SYS + [4, 5], [9, 9, 9, 2, 6]]
    done, eng = _engine(cfg, fused, prompts, 6, preseed=SYS, batch_slots=2,
                        max_seq_len=64, prefill_chunk=4, prefix_cache=2,
                        prefix_cache_auto=True, attn_windows=(32, 64),
                        decode_block=4)
    assert eng.metrics.prefix_hits == 2
    assert calls["v1"] > 0 and calls["mlp"] > calls["v1"]
    for p, r in zip(prompts, done):
        assert_tokens_match_guarded(_fwd(cfg, fused), p, r.tokens,
                                    _single(cfg, fused, p, 6))
