"""Mixtral-style MoE in the port against the JAX package on the CPU: the
ragged routing and the token scatter / combine, expert stacks quantized and
carried across byte for byte, each ragged kernel's plain version against
its Pallas kernel in interpret mode, the ragged and dense-masked MoE
against JAX's, the tiny MoE model's logits and engine tokens, and which
route each of the reference's gates picks."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from piquant_tpu.models import llama as JM
from piquant_tpu.ops.pallas import qmatmul as JQ
from piquant_tpu.quant import linear as JL
from piquant_tpu.quant import moe as JMOE
from piquant_tpu_torch import convert
from piquant_tpu_torch.models import llama as TM
from piquant_tpu_torch.ops.cuda import qmatmul as TQ
from piquant_tpu_torch.ops.cuda import ragged as TR
from piquant_tpu_torch.quant import linear as TL
from piquant_tpu_torch.quant import moe as TMOE
from test_torch_model import _check_logits, _run_jax, _run_port
from token_guard import assert_tokens_match_guarded
from _torch_threads import one_thread  # noqa: F401

SEED = 0x3E
CPU = torch.device("cpu")
RAGGED = ("wq_ragged", "wq_ragged_grouped", "wq_ragged_a8")
GEMVS = ("w4_gemv", "w8_gemv", "w2_gemv", "wg_chunk", "w4_grouped", "w4a8",
         "w8a8", "w2a8")


def _t(a):
    return convert.tensor_from_numpy(a, CPU)


@pytest.fixture
def counted(monkeypatch):
    """Calls of each ragged and GEMV wrapper on the CPU, where it runs its
    plain version: {name: count}."""
    calls = dict.fromkeys(RAGGED + GEMVS, 0)
    for mod, names in ((TR, RAGGED), (TQ, GEMVS)):
        for name in names:
            plain = getattr(mod, name + "_plain")

            def bump(*a, _name=name, _plain=plain, **k):
                calls[_name] += 1
                return _plain(*a, **k)

            monkeypatch.setattr(mod, name + "_plain", bump)
    return calls


def _tiny_moe(**kw):
    return JM.LlamaConfig.tiny(n_experts=4, moe_top_k=2, **kw)


def _moe_setup(seed, bits=4, group_size=None, **cfg_kw):
    """The tiny MoE config quantized by JAX and carried across."""
    jcfg = _tiny_moe(**cfg_kw)
    jparams = JM.quantize_params(JM.init_params(jcfg, jax.random.key(seed)),
                                 bits=bits, group_size=group_size)
    return (jcfg, jparams, convert.config_from_jax(jcfg),
            convert.params_from_jax(jparams, device=CPU))


def _jax_routing(jcfg, layer, x):
    logits = jnp.einsum("btd,de->bte", x.astype(jnp.float32),
                        layer["router"].astype(jnp.float32))
    probs, topi = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                                jcfg.moe_top_k)
    return probs / jnp.sum(probs, axis=-1, keepdims=True), topi


def _x(jcfg, b, t, seed):
    return jax.random.normal(jax.random.key(seed), (b, t, jcfg.d_model),
                             jcfg.dtype) * 0.5


# ---------------------------------------------------------------------------
# routing, scatter, combine: bit for bit
# ---------------------------------------------------------------------------

def _topi(e, k, ntok, seed, skew):
    """top-k expert ids and probabilities [1, ntok, k]; `skew` leaves
    expert 0 without a token and sends most to expert 1."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 1, (ntok, e))
    if skew:
        logits[:, 0] -= 50
        logits[:, 1] += 3
    topi = np.argsort(-logits, axis=1, kind="stable")[:, :k]
    probs = rng.uniform(0, 1, (ntok, k)).astype(np.float32)
    return topi[None].astype(np.int32), probs[None]


@pytest.mark.parametrize("e,k,ntok,bm,skew", [
    (5, 2, 37, 8, False), (8, 2, 300, 128, False), (8, 2, 1024, 128, True),
    (4, 2, 64, 128, True), (8, 1, 5, 16, False)])
def test_routing_matches_jax(e, k, ntok, bm, skew):
    topi, probs = _topi(e, k, ntok, SEED + ntok, skew)
    j = JMOE.build_ragged_routing(jnp.asarray(topi), jnp.asarray(probs), e, bm)
    r = TMOE.build_ragged_routing(_t(topi), _t(probs), e, bm)
    assert r.m_pad == j.m_pad
    for f in ("dest", "token_idx", "block_expert"):
        np.testing.assert_array_equal(getattr(r, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert r.block_expert.dtype == torch.int32
    np.testing.assert_array_equal(r.gate.numpy().view(np.int32),
                                  np.asarray(j.gate, np.float32).view(np.int32))
    if skew:
        assert 0 not in r.block_expert[:int(r.dest.max()) // bm + 1].tolist()


# live_blocks (the blocks before the padding tail, on the device) is the
# sum of each expert's count rounded up to whole blocks.
@pytest.mark.parametrize("e,k,ntok,bm,skew", [
    (5, 2, 37, 8, False), (8, 2, 300, 128, False), (8, 2, 1024, 128, True),
    (4, 2, 64, 128, True), (8, 1, 5, 16, False)])
def test_live_blocks_match_counts(e, k, ntok, bm, skew):
    topi, probs = _topi(e, k, ntok, SEED + ntok, skew)
    r = TMOE.build_ragged_routing(_t(topi), _t(probs), e, bm)
    counts = np.bincount(topi.reshape(-1), minlength=e)
    assert r.live_blocks.dtype == torch.int32 and r.live_blocks.shape == (1,)
    assert int(r.live_blocks) == int(((counts + bm - 1) // bm).sum())
    assert int(r.live_blocks) * bm <= r.m_pad


def test_scatter_and_combine_match_jax():
    e, k, ntok, d = 6, 2, 45, 64
    topi, probs = _topi(e, k, ntok, SEED, False)
    rng = np.random.default_rng(SEED)
    x = rng.normal(0, 1, (ntok, d)).astype(np.float32)
    j = JMOE.build_ragged_routing(jnp.asarray(topi), jnp.asarray(probs), e, 8)
    r = TMOE.build_ragged_routing(_t(topi), _t(probs), e, 8)
    js = JMOE.scatter_tokens(jnp.asarray(x), j)
    ts = TMOE.scatter_tokens(_t(x), r)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    y = rng.normal(0, 1, (r.m_pad, d)).astype(np.float32)
    jc = np.asarray(JMOE.combine_tokens(jnp.asarray(y), j, ntok))
    tc = TMOE.combine_tokens(_t(y), r, ntok)
    assert tc.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), jc)


# ---------------------------------------------------------------------------
# expert stacks: quantized and carried across byte for byte
# ---------------------------------------------------------------------------

STACK_FIELDS = ("data", "scale", "zero_point", "s_chunk", "z_chunk")


def _same_stack(mine, ref):
    assert isinstance(mine, TL.QuantizedExpertStack)
    assert (mine.bits, mine.k, mine.group_size) == (ref.bits, ref.k,
                                                    ref.group_size)
    for f in STACK_FIELDS:
        a, b = getattr(mine, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32),
                                          err_msg=f)


@pytest.mark.parametrize("bits,gs", [(4, None), (2, None), (8, None),
                                     (4, 32), (2, 32)])
def test_quantize_params_stacks_byte_equal(bits, gs):
    jcfg = _tiny_moe()
    jfloat = JM.init_params(jcfg, jax.random.key(SEED + bits))
    jparams = JM.quantize_params(jfloat, bits=bits, group_size=gs)
    mine = TM.quantize_params(convert.params_from_jax(jfloat, device=CPU),
                              bits=bits, group_size=gs)
    carried = convert.params_from_jax(jparams, device=CPU)
    for jl, ml, cl in zip(jparams["layers"], mine["layers"],
                          carried["layers"]):
        assert "w1" not in ml and torch.equal(ml["router"], cl["router"])
        for key in TM._MOE_QUANT_KEYS:
            _same_stack(ml[key], jl[key])
            _same_stack(cl[key], jl[key])
            assert ml[key].expert(1).data.shape == jl[key].expert(1).data.shape


@pytest.mark.parametrize("bits,gs", [(4, None), (2, 32)])
def test_convert_expert_stack(bits, gs):
    """A JAX QuantizedExpertStack carried across stays a stack (its fields
    are a QuantizedLinear's too, so the duck typing checks it first)."""
    rng = np.random.default_rng(SEED)
    qls = [JL.quantize_linear_weight(
        jnp.asarray(rng.normal(0, 0.05, (512, 256)).astype(np.float32)),
        bits, group_size=gs) for _ in range(3)]
    stack = JL.QuantizedExpertStack.stack(qls)
    got = convert.params_from_jax({"moe_w1": stack, "w": qls[0]},
                                  device=CPU)
    _same_stack(got["moe_w1"], stack)
    assert got["moe_w1"].n_experts == 3 and got["moe_w1"].n == 256
    assert isinstance(got["w"], TL.QuantizedLinear)
    assert got["w"].data.dim() == 2
    with pytest.raises(ValueError, match="share geometry"):
        TL.QuantizedExpertStack.stack([got["w"], TL.quantize_linear_weight(
            torch.zeros(256, 256), bits, group_size=gs)])


def test_config_and_random_params_follow_the_reference():
    cfg = convert.config_from_jax(JM.LlamaConfig.mixtral_8x7b())
    assert cfg == TM.LlamaConfig.mixtral_8x7b()
    assert [cfg.moe_layer(i) for i in (0, 31)] == [True, True]
    # the MoE flags of queue 1 item 5 carry across since it was ported;
    # expert parallelism still raises
    for flag in ("router_bias", "moe_bias", "moe_clamp_swiglu",
                 "moe_input_scaled"):
        assert getattr(convert.config_from_jax(_tiny_moe(**{flag: True})),
                       flag) is True
    with pytest.raises(NotImplementedError, match="moe_a2a"):
        convert.config_from_jax(_tiny_moe(moe_a2a=True))
    shared = convert.config_from_jax(_tiny_moe(shared_expert_d_ff=64,
                                               shared_expert_gated=False))
    assert (shared.shared_expert_d_ff, shared.shared_expert_gated) == (64,
                                                                       False)
    with pytest.raises(NotImplementedError, match="ep_axis"):
        convert.config_from_jax(_tiny_moe(ep_axis="ep"))
    jcfg = _tiny_moe(moe_every=2, moe_d_ff=256)
    tcfg = convert.config_from_jax(jcfg)
    for kw in (dict(bits=4, lm_head_bits=8), dict(bits=4, group_size=32),
               dict(bits=2, group_size=32, mlp_bits=8)):
        j = JM.random_quantized_params(jcfg, jax.random.key(1), **kw)
        t = TM.random_quantized_params(tcfg, 1, device="cpu", **kw)
        for jl, tl in zip(j["layers"], t["layers"]):
            assert sorted(jl) == sorted(tl)
            for key in tl:
                a, b = jl[key], tl[key]
                if not hasattr(a, "bits"):
                    assert tuple(b.shape) == a.shape
                    continue
                assert (b.bits, b.k, b.group_size) == (a.bits, a.k,
                                                       a.group_size), key
                assert tuple(b.data.shape) == a.data.shape, key
                for f in STACK_FIELDS[1:]:
                    x, y = getattr(a, f), getattr(b, f)
                    assert (x is None) == (y is None), (key, f)
                    if x is not None:
                        np.testing.assert_array_equal(
                            y.float().numpy(), np.asarray(x, np.float32))


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _stack_both(bits, gs, k, n, e, seed):
    rng = np.random.default_rng(seed)
    ws = [rng.normal(0, 0.05, (k, n)).astype(np.float32) for _ in range(e)]
    j = JL.QuantizedExpertStack.stack(
        [JL.quantize_linear_weight(jnp.asarray(w), bits, group_size=gs)
         for w in ws])
    return j, convert.params_from_jax(j, device=CPU)


def _sorted_x(k, e, ntok, seed, skew=True):
    """x sorted and padded by a skewed routing (an expert without tokens,
    one with most), and block_expert, as numpy."""
    topi, probs = _topi(e, 2, ntok, seed, skew)
    r = TMOE.build_ragged_routing(_t(topi), _t(probs), e, TR.ROW_BLOCK)
    x = np.random.default_rng(seed).normal(0, 1, (ntok, k)).astype(np.float32)
    xs = TMOE.scatter_tokens(_t(x).to(torch.bfloat16), r)
    return xs, r.block_expert


# Per element within atol 2e-2, rtol 1e-2 (the quantized_matmul bound of
# the JAX tests): the same bf16 operands and roundings, f32 sums in another
# order, one bf16 rounding of the output.
@pytest.mark.parametrize("bits,gs", [(2, None), (4, None), (8, None),
                                     (2, 32), (4, 32)])
def test_ragged_matches_pallas(counted, bits, gs):
    e, k, n = 4, 512, 256
    j, t = _stack_both(bits, gs, k, n, e, SEED + bits)
    xs, be = _sorted_x(k, e, 100, SEED)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JQ.wq_ragged_matmul(
            jnp.asarray(xs.float().numpy()).astype(jnp.bfloat16), j,
            jnp.asarray(be.numpy()), jnp.float32))
    got = TR.wq_ragged_matmul(xs, t, be, torch.float32)
    assert counted["wq_ragged_grouped" if gs else "wq_ragged"] == 1
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=1e-2)


# atol 1e-4, rtol 1e-5 (the a8 bound of tests/test_torch_actquant.py): the
# int32 products are exact in both; the f32 epilogue may contract
# differently in XLA.
@pytest.mark.parametrize("bits", [2, 4])
def test_ragged_a8_matches_pallas(counted, bits):
    e, k, n = 4, 512, 256
    j, t = _stack_both(bits, None, k, n, e, SEED + bits)
    xs, be = _sorted_x(k, e, 100, SEED + 1)
    xq, xsc = JL._quantize_act(jnp.asarray(xs.float().numpy()))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JQ.wq_ragged_matmul_a8(
            xq, xsc, j, jnp.asarray(be.numpy()), jnp.float32))
    got = TR.wq_ragged_matmul_a8(_t(np.asarray(xq)), _t(np.asarray(xsc)), t,
                                 be, torch.float32)
    assert counted["wq_ragged_a8"] == 1
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


# The plain versions with the routing's live_blocks equal them without it:
# the blocks past it hold only padding rows, whose outputs are zero.
@pytest.mark.parametrize("gs", [None, 32])
def test_ragged_plain_live_blocks(gs):
    e, k, n = 4, 256, 128
    _, t = _stack_both(4, gs, k, n, e, SEED + 5)
    topi, probs = _topi(e, 2, 60, SEED + 3, True)
    r = TMOE.build_ragged_routing(_t(topi), _t(probs), e, TR.ROW_BLOCK)
    assert int(r.live_blocks) < r.m_pad // TR.ROW_BLOCK
    xs = TMOE.scatter_tokens(_t(np.random.default_rng(SEED).normal(
        0, 1, (60, k)).astype(np.float32)).to(torch.bfloat16), r)
    full = TR.wq_ragged_matmul(xs, t, r.block_expert, torch.float32)
    live = TR.wq_ragged_matmul(xs, t, r.block_expert, torch.float32,
                               r.live_blocks)
    assert torch.equal(full, live)
    assert not live[int(r.live_blocks) * TR.ROW_BLOCK:].any()


def test_ragged_dispatch_declines_as_the_reference():
    """The semantic gates decline in both packages."""
    _, t4 = _stack_both(4, None, 512, 256, 2, SEED)
    _, g4 = _stack_both(4, 32, 512, 256, 2, SEED)
    x = torch.zeros((256, 512), dtype=torch.bfloat16)
    be = torch.zeros(2, dtype=torch.int32)
    assert TR.wq_ragged_matmul(x[:255], t4, be) is None        # M % blocks
    assert TR.wq_ragged_matmul(x[:, :256], t4, be) is None     # packed rows
    bad = dataclasses.replace(g4, scale=g4.scale[:, :8].contiguous())
    assert TR.wq_ragged_matmul(x, bad, be) is None             # scale shape
    xq = torch.zeros((256, 512), dtype=torch.int8)
    xs = torch.ones((256, 1))
    assert TR.wq_ragged_matmul_a8(xq, xs, g4, be) is None      # grouped
    _, t8 = _stack_both(8, None, 512, 256, 2, SEED)
    assert TR.wq_ragged_matmul_a8(xq, xs, t8, be) is None      # INT8


# The TPU's VMEM budgets (W_BLOCK_VMEM_LIMIT and the bn it picks) are
# dropped: each case below is declined by the reference's dispatch and
# computed by the port's (ROADMAP.md section 3).
@pytest.mark.parametrize("fn,bits,gs,k", [
    ("wq_ragged_matmul", 8, None, 14336),      # Mixtral's INT8 w2
    ("wq_ragged_matmul", 4, 32, 22528),        # grouped: rows + 8 G > 16384
    ("wq_ragged_matmul_a8", 4, None, 16896)])  # a8: rows > 8192
def test_vmem_declines_are_dropped(counted, fn, bits, gs, k):
    e, n = 2, 128
    rng = np.random.default_rng(SEED + k)
    g = k // gs if gs else 1
    j = JL.QuantizedExpertStack(
        data=jnp.asarray(rng.integers(0, 256, (e, k * bits // 8, n),
                                      dtype=np.uint8)),
        scale=jnp.asarray(rng.uniform(1e-3, 2e-3, (e, g, n)), jnp.float32),
        zero_point=jnp.asarray(rng.integers(0, 1 << bits, (e, g, n)),
                               jnp.int32),
        bits=bits, k=k, group_size=gs)
    t = convert.params_from_jax(j, device=CPU)
    xs, be = _sorted_x(k, e, 40, SEED + 2, skew=False)
    if fn == "wq_ragged_matmul":
        args = (xs,)
        jargs = (jnp.asarray(xs.float().numpy()).astype(jnp.bfloat16),)
    else:
        xq, xsc = TL._quantize_act(xs)
        args = (xq, xsc)
        jargs = (jnp.asarray(xq.numpy()), jnp.asarray(xsc.numpy()))
    assert getattr(JQ, fn)(*jargs, j, jnp.asarray(be.numpy())) is None
    got = getattr(TR, fn)(*args, t, be, torch.float32)
    assert got is not None and got.shape == (xs.shape[0], n)
    assert bool(torch.isfinite(got).all())
    # each expert's rows against the product with its dequantized weight
    # (atol 5e-2, rtol 2e-2: bf16 x or int8 x against f32 x, f32 sums)
    row_e = be.long().repeat_interleave(TR.ROW_BLOCK)
    xin = xs.float() if len(args) == 1 else args[0].float() * args[1]
    for i in range(e):
        rows = row_e == i
        want = xin[rows] @ t.expert(i).dequantize(torch.float32)
        torch.testing.assert_close(got[rows], want, atol=5e-2, rtol=2e-2)


# ---------------------------------------------------------------------------
# the MoE routes against JAX's
# ---------------------------------------------------------------------------

def _port_routing(probs, topi):
    return _t(np.asarray(probs)), _t(np.asarray(topi)).long()


# Ragged against JAX's ragged (forced through its Pallas kernels in
# interpret mode) on the same routing: max |port - jax| <= 1e-2 * max|jax|,
# the same algorithm with f32 sums in other orders, whose bf16 roundings of
# g, u and h may land an ulp apart (and under act-quant redraw an int8
# code); measured at most 2.3e-3.  (The reference's own ragged-vs-dense
# test bounds the absolute error by 2e-2 on outputs of this size, ~0.02.)
@pytest.mark.parametrize("bits,gs,aq", [(4, None, False), (2, None, False),
                                        (8, None, False), (4, 32, False),
                                        (2, 32, False), (4, None, True),
                                        (2, None, True)])
def test_moe_ragged_matches_jax(counted, monkeypatch, bits, gs, aq):
    jcfg, jparams, cfg, params = _moe_setup(SEED + bits, bits, gs,
                                            act_quant_decode=aq)
    jl, tl = jparams["layers"][0], params["layers"][0]
    x = _x(jcfg, 2, 32, SEED)
    probs, topi = _jax_routing(jcfg, jl, x)
    monkeypatch.setenv("PIQUANT_MOE_RAGGED", "force")
    with pltpu.force_tpu_interpret_mode():
        want = JM._moe_ragged_try(jcfg, jl, x, probs, topi)
    monkeypatch.setenv("PIQUANT_MOE_RAGGED", "1")
    assert want is not None
    want = np.asarray(want)
    got = TM._moe_ragged_try(cfg, tl, _t(np.asarray(x)),
                             *_port_routing(probs, topi))
    assert got is not None and got.dtype == torch.float32
    kernel = "wq_ragged_a8" if aq else ("wq_ragged_grouped" if gs
                                         else "wq_ragged")
    assert counted[kernel] == 3
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-2, err


# Dense-masked against JAX's on the same routing: the same bound (the
# expert products take JAX's CPU dequant path and the port's decode-M
# kernels' plain versions, whose bf16 roundings of g, u, h may land an ulp
# apart); measured at most 5.9e-3.
@pytest.mark.parametrize("bits,gs,t", [(4, None, 16), (4, 32, 16),
                                       (2, None, 40), (8, None, 8)])
def test_moe_dense_matches_jax(bits, gs, t):
    jcfg, jparams, cfg, params = _moe_setup(SEED + 7 * bits, bits, gs)
    jl, tl = jparams["layers"][1], params["layers"][1]
    x = _x(jcfg, 1, t, SEED + 1)
    probs, topi = _jax_routing(jcfg, jl, x)
    want = np.asarray(JM._moe_dense(jcfg, jl, x, probs, topi, 4, 0, False))
    got = TM._moe_dense(cfg, tl, _t(np.asarray(x)),
                        *_port_routing(probs, topi), False)
    assert got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-2, err


# ---------------------------------------------------------------------------
# the tiny MoE model and engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,gs", [(4, None), (4, 32)])
def test_moe_model_matches_jax(counted, bits, gs):
    """Prefill (ragged in the port, dense in JAX on the CPU: the same
    function) and 3 decode steps (dense in both), within LOGIT_TOL
    (tests/test_torch_model.py), argmax equal where there is no near
    tie."""
    jcfg, jparams, cfg, params = _moe_setup(SEED + 11, bits, gs)
    rng = np.random.default_rng(SEED)
    toks = jnp.asarray(rng.integers(1, cfg.vocab_size, (2, 48 + 3)),
                       jnp.int32)
    got = _run_port(cfg, params, toks, 3)
    assert counted["wq_ragged_grouped" if gs else "wq_ragged"] == (
        3 * cfg.n_layers)
    _check_logits(got, _run_jax(jcfg, jparams, toks, 3, jit=True))


def _greedy(cfg, params, prompt, n_new):
    cache = TM.init_kv_cache(cfg, 1, max_len=len(prompt) + n_new,
                             device=CPU)
    logits, cache = TM.prefill(cfg, params, torch.tensor([prompt]), cache)
    toks = [int(logits.argmax(-1))]
    for i in range(n_new - 1):
        logits, cache = TM.decode_step(
            cfg, params, torch.tensor([toks[-1]], dtype=torch.int32),
            torch.tensor([len(prompt) + i], dtype=torch.int32), cache)
        toks.append(int(logits.argmax(-1)))
    return toks


def test_engine_matches_single_request():
    from piquant_tpu_torch.serving import (Engine, EngineConfig, Request,
                                           SamplingParams)

    _, _, cfg, params = _moe_setup(SEED + 13)
    rng = np.random.default_rng(SEED)
    eng = Engine(cfg, params, EngineConfig(batch_slots=4, max_seq_len=128),
                 device=CPU)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (40, 70, 33, 90)]
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p,
                           sampling=SamplingParams(max_new_tokens=6)))
    done = sorted(eng.run(), key=lambda r: r.rid)
    assert len(done) == 4

    def forward(tokens):
        logits, _ = TM.forward(cfg, params, _t(np.asarray(tokens)))
        return logits.numpy()

    for r, p in zip(done, prompts):
        assert_tokens_match_guarded(forward, p, r.tokens,
                                    _greedy(cfg, params, p, 6),
                                    tag=f"request {r.rid}")


# ---------------------------------------------------------------------------
# the route each gate picks
# ---------------------------------------------------------------------------

# (config keywords, bits, group size, tokens) -> the route one MoE layer
# takes: a ragged wrapper (3 calls) or "dense" (no ragged call)
ROUTES = [
    (dict(), 4, None, 16, "dense"),                     # ntok < 32
    (dict(), 4, None, 32, "wq_ragged"),
    (dict(), 8, None, 64, "wq_ragged"),
    (dict(), 2, 32, 64, "wq_ragged_grouped"),
    (dict(act_quant_decode=True), 4, 32, 64, "dense"),  # act-quant, grouped
    (dict(act_quant_decode=True), 8, None, 64, "dense"),  # act-quant, INT8
    (dict(act_quant_prefill=True), 4, None, 64, "dense"),  # ntok < 256
    (dict(act_quant_prefill=True), 4, None, 256, "wq_ragged_a8"),
    (dict(act_quant_decode=True), 2, None, 40, "wq_ragged_a8"),
]


@pytest.mark.parametrize("kw,bits,gs,ntok,route", ROUTES)
def test_moe_routes(counted, kw, bits, gs, ntok, route):
    _, _, cfg, params = _moe_setup(SEED + 17, bits, gs, **kw)
    x = torch.randn((1, ntok, cfg.d_model),
                    generator=torch.Generator().manual_seed(ntok)
                    ).to(cfg.dtype)
    y = TM._mlp(cfg, params["layers"][0], x)
    assert y.shape == x.shape and y.dtype == cfg.dtype
    assert bool(torch.isfinite(y).all())
    ragged = {k: counted[k] for k in RAGGED if counted[k]}
    assert ragged == ({} if route == "dense" else {route: 3})
    if route == "dense" and ntok <= TQ.M_MAX:
        # 4 experts x 3 projections, each through a decode-M kernel
        assert sum(counted[k] for k in GEMVS) == 12


def test_moe_routes_int8_w2_stays_ragged(counted):
    """Mixtral's INT8 w2 (K 14336): the reference's VMEM budget sends its
    whole MoE layer dense; the port keeps it ragged."""
    cfg = TM.LlamaConfig(vocab_size=64, d_model=256, n_layers=1, n_heads=2,
                         n_kv_heads=1, d_ff=14336, max_seq_len=64,
                         n_experts=2, moe_top_k=2)
    params = TM.random_quantized_params(cfg, 3, bits=8, device="cpu")
    x = torch.randn((1, 32, 256), generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    y = TM._mlp(cfg, params["layers"][0], x)
    assert counted["wq_ragged"] == 3 and bool(torch.isfinite(y).all())
