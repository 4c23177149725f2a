"""Gradients through the port's flash attention on the CPU
(piquant_tpu_torch/ops/cuda/flash.py): the plain version's autograd against
`jax.vjp` of the JAX-shipped flash kernel's own reference (`mha_reference`,
whose custom VJP is `mha_reference_bwd`), the backward kernels' plain
versions (P recomputed from the saved log-sum-exps, GQA-summed dK / dV)
against that autograd at each mask, and whole tiny models (a Mistral-like
window, a Llama-4-like chunk) through flash against `jax.grad` of the JAX
forward (materialized attention).  Every wrapper that launches a kernel
without a backward refuses grad.  Tolerances: `flash.bwd_rounding_bound`
(five bf16 roundings of the summed |terms| of dQ and dK, four of dV's)
element by element, `flash.BWD_NORM_RTOL` (2u) norm-wise, which planted
faults fail, and the models' below."""

import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import (
    mha_reference, mha_reference_no_custom_vjp)

from piquant_tpu.models import llama as JM
from piquant_tpu_torch import convert
from piquant_tpu_torch.ops.cuda import _build
from piquant_tpu_torch.ops.cuda import flash as FL
from piquant_tpu_torch.utils import tree
from tests.torch_dist_worker import lm_loss
from _torch_threads import one_thread  # noqa: F401

SEED = 0xF1A5


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _inputs(b, hkv, rep, t, d=128, q_scale=1.0, seed=SEED):
    rng = np.random.default_rng(seed)
    q = _bf16((rng.normal(size=(b, hkv, rep, t, d)) * q_scale)
              .astype(np.float32))
    k = _bf16(rng.normal(size=(b, hkv, t, d)).astype(np.float32))
    v = _bf16(rng.normal(size=(b, hkv, t, d)).astype(np.float32))
    do = rng.normal(size=(b, hkv, rep, t, d)).astype(np.float32)
    return q, k, v, do


def _within(got, want, bound, what):
    gap = (got - want).abs()
    assert bool((gap <= bound).all()), (
        f"{what}: {int((gap > bound).sum())} elements beyond the bound, "
        f"max gap {float(gap.max())}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_grads_match_shipped_reference(dtype):
    """B 2, Hkv 2, rep 2, T 256, D 128, causal: mha_reference on K/V
    repeated to the query heads (its VJP sums dK / dV over them, as the
    reference's prefill does); the scale folded into q, since
    mha_reference_bwd takes sm_scale 1.  bf16 inputs, as the reference's
    prefill hands them, also round the gradients to bf16 (under u of each
    one, within the bound)."""
    b, hkv, rep, t, d = 2, 2, 2, 256, 128
    q, k, v, do = _inputs(b, hkv, rep, t, q_scale=d ** -0.5)
    dt = getattr(jnp, dtype)

    def f(q, k, v):
        o = mha_reference(q.reshape(b, hkv * rep, t, d),
                          jnp.repeat(k, rep, 1), jnp.repeat(v, rep, 1),
                          None, causal=True, sm_scale=1.0)
        return o.reshape(q.shape)

    _, vjp = jax.vjp(f, *(jnp.asarray(a, dt) for a in (q, k, v)))
    want = vjp(jnp.asarray(do, dt))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    got = FL.flash_attn_bwd_plain(tq, tk, tv, tdo, 1.0)
    bounds = FL.bwd_rounding_bound(tq, tk, tv, tdo, 1.0)
    for name, g, w, bd in zip("qkv", got, want, bounds):
        _within(g, torch.from_numpy(np.asarray(w, np.float32)), bd,
                f"d{name} ({dtype})")


def test_lse_matches_shipped_reference():
    """flash_attn_lse_plain is the shipped reference's m + log l."""
    b, hkv, rep, t, d = 2, 2, 2, 256, 128
    q, k, v, _ = _inputs(b, hkv, rep, t, q_scale=d ** -0.5)
    _, l, m = mha_reference_no_custom_vjp(
        jnp.asarray(q).reshape(b, hkv * rep, t, d),
        jnp.repeat(jnp.asarray(k), rep, 1),
        jnp.repeat(jnp.asarray(v), rep, 1), causal=True, sm_scale=1.0,
        save_residuals=True)
    got = FL.flash_attn_lse_plain(torch.from_numpy(q), torch.from_numpy(k),
                                  1.0)
    np.testing.assert_allclose(got.numpy().reshape(b, hkv * rep, t),
                               np.asarray(m + jnp.log(l)), rtol=1e-6,
                               atol=2e-6)


# (b, hkv, rep, t, window, chunk, pos0): causal at reps 1 and 3 and a
# ragged T; a window off the 64-key tiles; chunks with row 0 at positions
# past 0
MASKS = [(2, 2, 1, 192, None, None, None), (1, 2, 3, 200, None, None, None),
         (1, 1, 4, 256, 50, None, None), (2, 1, 2, 256, None, 64, (30, 100)),
         (1, 2, 5, 130, None, 100, (7,))]


@pytest.mark.parametrize("b,hkv,rep,t,window,chunk,pos0", MASKS)
def test_kernel_plain_versions_match_autograd(b, hkv, rep, t, window, chunk,
                                              pos0):
    """flash_bwd_delta / flash_bwd_dkv / flash_bwd_dq on CPU tensors (the
    kernels' plain versions: P from the forward's log-sum-exps, bf16 dO, P
    and dS, dK and dV summed over the rep heads) against the autograd of
    flash_attn_plain, within bwd_rounding_bound element by element and
    within BWD_NORM_RTOL norm-wise on each (b, head) slice."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(b, hkv, rep, t))
    p0 = None if pos0 is None else torch.tensor(pos0)
    sm = 128 ** -0.5
    o = FL.flash_attn_plain(q, k, v, sm, window, None, chunk, p0)
    lse = FL.flash_attn_lse_plain(q, k, sm, window, chunk, p0)
    delta, dob = FL.flash_bwd_delta(o, do)
    assert dob.dtype == torch.bfloat16
    dk, dv = FL.flash_bwd_dkv(q, k, v, dob, lse, delta, sm, window, chunk,
                              p0)
    dq = FL.flash_bwd_dq(q, k, v, dob, lse, delta, sm, window, chunk, p0)
    want = FL.flash_attn_bwd_plain(q, k, v, do, sm, window, chunk, p0)
    bounds = FL.bwd_rounding_bound(q, k, v, do, sm, window, chunk, p0)
    for name, g, w, bd in zip("qkv", (dq, dk, dv), want, bounds):
        assert g.shape == w.shape
        _within(g, w, bd, f"d{name}")
    assert max(FL.bwd_norm_gap((dq, dk, dv), want)) <= FL.BWD_NORM_RTOL


# (b, hkv, rep, t, window, chunk, pos0) of the planted faults: Mistral's
# window of 1000, where the window's start moved by one key moves pairs of
# ~1/1000 of their row's probability (elementwise far under
# bwd_rounding_bound); the causal mask; a chunk with row 0 past 0
FAULT_SHAPES = [(1, 1, 2, 2048, 1000, None, None),
                (1, 2, 2, 512, None, None, None),
                (2, 1, 2, 512, None, 256, (300, 0))]


@pytest.mark.parametrize("b,hkv,rep,t,window,chunk,pos0", FAULT_SHAPES)
def test_norm_check_sees_planted_faults(b, hkv, rep, t, window, chunk,
                                        pos0):
    """The norm-wise check (`bwd_norm_gap` within BWD_NORM_RTOL, 2u) passes
    the kernels' plain versions and fails each fault that
    `chip_smoke.planted_faults` plants in their arguments: delta left 0, a
    query tile skipped, a tile's log-sum-exps from the tile before, the
    window's start one key off either way, pos0 one off under a chunk."""
    import chip_smoke

    q, k, v, do = (torch.from_numpy(a) for a in _inputs(b, hkv, rep, t))
    p0 = None if pos0 is None else torch.tensor(pos0, dtype=torch.int32)
    sm = 128 ** -0.5
    o = FL.flash_attn_plain(q, k, v, sm, window, None, chunk, p0)
    lse = FL.flash_attn_lse_plain(q, k, sm, window, chunk, p0)
    delta, dob = FL.flash_bwd_delta(o, do)
    want = FL.flash_attn_bwd_plain(q, k, v, do, sm, window, chunk, p0)
    args = (q, k, v, dob, lse, delta, sm, window, chunk, p0)
    sound = (FL.flash_bwd_dq(*args),) + FL.flash_bwd_dkv(*args)
    assert max(FL.bwd_norm_gap(sound, want)) <= FL.BWD_NORM_RTOL
    faults = chip_smoke.planted_faults(torch, FL, args, want)
    assert len(faults) == 3 + 2 * (window is not None) + (chunk is not None)
    assert all(r > FL.BWD_NORM_RTOL for r in faults.values()), faults


# The tiny models' gradients, leaf by leaf: within 2e-2 of the leaf's
# largest |gradient| (4.9e-3 measured).  The port's flash plain version
# rounds the unnormalized probabilities to bf16 and divides after the PV
# product; the JAX package's materialized path rounds the normalized ones:
# the contexts part by a bf16 rounding, and the gradients with them.
MODEL_RTOL = 2e-2
TINY = dict(vocab_size=256, d_model=256, n_layers=2, n_heads=2,
            n_kv_heads=1, d_ff=512, max_seq_len=256, dtype=jnp.float32)


@pytest.mark.parametrize("family", ["mistral", "llama4"])
def test_model_grads_match_jax(family, monkeypatch):
    """A Mistral-like model (window 48) and a Llama-4-like one (chunk 64,
    its nope layer, temperature tuning and L2 qk-norm) at head_dim 128 and
    T 128: every layer attends through flash_attn (its plain version on the
    CPU), and the port's gradients of the next-token loss match jax.grad
    of the JAX forward's (materialized attention on the CPU)."""
    flags = (dict(sliding_window=48) if family == "mistral" else
             dict(chunk_window=64, nope_pattern=2, qk_l2norm=True,
                  attn_temp_tuning=True))
    jcfg = JM.LlamaConfig(**TINY, **flags)
    jparams = JM.init_params(jcfg, jax.random.key(5))
    batch = np.random.default_rng(6).integers(0, 256, (2, 129)).astype(
        np.int32)

    def jloss(p):
        logits, _ = JM.forward(jcfg, p, jnp.asarray(batch[:, :-1]))
        lp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return -jnp.take_along_axis(lp, batch[:, 1:, None], axis=-1).mean()

    want = jax.tree.leaves(jax.grad(jloss)(jparams))
    cfg = convert.config_from_jax(jcfg)
    leaves, unflatten = tree.flatten(convert.params_from_jax(jparams,
                                                             device="cpu"))
    calls = []
    plain = FL.flash_attn_plain
    monkeypatch.setattr(FL, "flash_attn_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    views = [x.detach().requires_grad_() for x in leaves]
    loss = lm_loss(cfg)(unflatten(views), torch.from_numpy(batch))
    got = torch.autograd.grad(loss, views)
    assert len(calls) == cfg.n_layers
    assert abs(float(loss.detach()) - float(jloss(jparams))) <= 1e-3 * float(
        loss.detach())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= MODEL_RTOL * np.abs(w).max()


def _launching_wrappers():
    """Every function of ops/cuda that counts a kernel launch."""
    from piquant_tpu_torch.ops.cuda import (attention, decode_attn2,
                                            dequantize, minmax, qmatmul,
                                            quantize, ragged, requantize,
                                            ring)
    mods = (attention, decode_attn2, dequantize, FL, minmax, qmatmul,
            quantize, ragged, requantize, ring)
    for mod in mods:
        for name, fn in inspect.getmembers(mod, inspect.isfunction):
            if fn.__module__ == mod.__name__ and ".launches += 1" in \
                    inspect.getsource(fn):
                yield name, fn


def test_every_kernel_wrapper_guards_grad():
    """Step 1 of the training slice: each wrapper that launches a kernel
    either refuses an input that requires grad (`_build.no_grad`, before
    its launch) or, flash_attn's forward alone, goes through an
    autograd.Function with a backward kernel."""
    names = []
    for name, fn in _launching_wrappers():
        src = inspect.getsource(fn)
        names.append(name)
        if name == "_forward":      # flash_attn's launch
            src = inspect.getsource(FL.flash_attn)
            assert "FlashAttnFunction.apply" in src and "is_grad_enabled" \
                in src
            continue
        assert "_build.no_grad(" in src, name
        assert src.index("_build.no_grad(") < src.index(".launches += 1")
    assert {"w4_gemv", "mlp_fused", "wq_ragged", "decode_attn2", "quantize",
            "ring_hop", "flash_bwd_dkv", "_forward"} <= set(names)


def test_no_grad_guard():
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="w4_gemv.*item 13"):
        _build.no_grad("w4_gemv", "13", x)
    with pytest.raises(NotImplementedError, match="item 16c"):
        _build.no_grad("wq_ragged", "16c", torch.zeros(2), x)
    with pytest.raises(NotImplementedError, match="serves only"):
        _build.no_grad("decode_attn2", "serving", x)
    with torch.no_grad():
        _build.no_grad("w4_gemv", "13", x)
    _build.no_grad("w4_gemv", "13", x.detach(), None)


def test_cpu_flash_differentiates():
    """On CPU tensors flash_attn is its plain version, which autograd
    differentiates (the mask, window and chunk included)."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 1, 2, 128))
    q.requires_grad_()
    out = FL.flash_attn(q, k, v, 0.1, chunk=64, pos0=torch.tensor([3]))
    (dq,) = torch.autograd.grad(out, q, do)
    want = FL.flash_attn_bwd_plain(q.detach(), k, v, do, 0.1, None, 64,
                                   torch.tensor([3]))[0]
    assert torch.equal(dq, want)
