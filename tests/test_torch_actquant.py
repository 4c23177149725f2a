"""Activation quantization (int8 per-token x) in the port against the JAX
package on the CPU: `_quantize_act` byte for byte, each a8 kernel's plain
version against its Pallas kernel in interpret mode, the wrapper each gate
picks, `quantized_matmul(act_quant=...)` against the JAX function, and the
model's logits and greedy tokens with the config flags set."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from piquant_tpu.models import llama as JM
from piquant_tpu.ops.pallas import qmatmul as JQ
from piquant_tpu.quant import linear as JL
from piquant_tpu_torch import convert
from piquant_tpu_torch.models import llama as TM
from piquant_tpu_torch.ops.cuda import qmatmul as TQ
from piquant_tpu_torch.quant import linear as TL
from test_torch_model import _run_jax, _run_port
from token_guard import assert_tokens_match_guarded

SEED = 0xA8
CPU = torch.device("cpu")
WRAPPERS = ("w4_gemv", "w8_gemv", "w2_gemv", "wg_chunk", "w4_grouped",
            "w4a8", "w8a8", "w2a8")


def _t(a):
    return convert.tensor_from_numpy(a, CPU)


@pytest.fixture
def counted(monkeypatch):
    """Each wrapper's calls on the CPU (where it runs its plain version),
    with the dtype of the x it was given: [(name, x dtype), ...]."""
    calls = []
    for name in WRAPPERS:
        plain = getattr(TQ, name + "_plain")

        def bump(x, *a, _name=name, _plain=plain, **k):
            calls.append((_name, x.dtype))
            return _plain(x, *a, **k)

        monkeypatch.setattr(TQ, name + "_plain", bump)
    return calls


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, as the CLI tests: the model's many small ops
    stall on a thread pool whose cores the other test workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) _quantize_act byte for byte
# ---------------------------------------------------------------------------

def _act_input(case):
    rng = np.random.default_rng(SEED)
    if case == "normal":
        return rng.normal(0, 1, (5, 512)).astype(np.float32)
    if case == "ties":
        # amax 127 gives xs = 1 and amax 254 gives xs = 2, so x / xs lands
        # on half codes: round half to even, not away from zero
        row = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5,
                        -126.5, 4.5, -4.5, 0.0, 6.5, -7.5, 8.5], np.float32)
        return np.stack([row, 2 * row, -row])
    if case == "zero_row":
        x = rng.normal(0, 3, (3, 256)).astype(np.float32)
        x[1] = 0.0
        return x
    if case == "bf16":
        import ml_dtypes
        return rng.normal(0, 2, (4, 384)).astype(ml_dtypes.bfloat16)
    if case == "lead_dims":
        return (rng.normal(0, 1, (2, 3, 256)) * 10.0 ** rng.integers(
            -6, 6, (2, 3, 1))).astype(np.float32)
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["normal", "ties", "zero_row", "bf16",
                                  "lead_dims"])
def test_quantize_act_byte_equal(case):
    x = _act_input(case)
    jq, js = JL._quantize_act(jnp.asarray(x))
    tq, ts = TL._quantize_act(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js, np.float32).view(np.int32))
    if case == "ties":
        assert tq[0, 1:12].tolist() == [0, 2, 2, 0, -2, -2, 4, 126, -126, 4,
                                        -4]
    if case == "zero_row":
        assert not tq[1].any() and float(ts[1]) == np.float32(1e-8) / 127


# ---------------------------------------------------------------------------
# (b) plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _both(bits, k, n, gs, m, seed):
    """The same weight quantized by both packages, and x [m, k] f32."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.05, (k, n)).astype(np.float32)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    jq = JL.quantize_linear_weight(jnp.asarray(w), bits, group_size=gs)
    tq = TL.quantize_linear_weight(_t(w), bits, group_size=gs)
    return x, jq, tq


def _a8_both(fn, bits, k, n, gs, m, seed):
    """(port, Pallas) outputs of a8 dispatch `fn` on the same xq, xs."""
    x, jq, tq = _both(bits, k, n, gs, m, seed)
    xq, xs = JL._quantize_act(jnp.asarray(x))
    with pltpu.force_tpu_interpret_mode():
        want = getattr(JQ, fn)(xq, xs, jq, jnp.float32)
        want = np.asarray(want)
    got = getattr(TQ, fn)(_t(np.asarray(xq)), _t(np.asarray(xs)), tq,
                          torch.float32)
    return got.numpy(), want


# atol 1e-4, rtol 1e-5 (tests/test_qmatmul.py's a8 bound): the products
# are exact in both; the f32 epilogue may contract differently in XLA.
@pytest.mark.parametrize("fn,bits,k,n,m,kernel", [
    ("w4a8_matmul", 4, 1024, 256, 256, "w4a8"),       # _w4a8_kernel
    ("w4a8_matmul", 4, 9216, 256, 256, "w4a8"),       # _w4a8_kernel_ksplit
    ("w8a8_matmul", 8, 512, 256, 384, "w8a8"),
    ("w2a8_matmul", 2, 1024, 256, 8, "w2a8"),
    ("w2a8_matmul", 2, 1024, 256, 256, "w2a8"),
])
def test_a8_matches_pallas(counted, fn, bits, k, n, m, kernel):
    got, want = _a8_both(fn, bits, k, n, None, m, SEED + k + m)
    assert counted == [(kernel, torch.int8)]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


# The chunk kernel's int8-x form at tests/test_qmatmul.py's W2A8-g / W4A8-g
# shapes (and two more M), atol 2e-2, rtol 2e-2: per-group f32 sums in
# another order.
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("m", [1, 8, 33])
def test_wg_chunk_int8_matches_pallas(counted, bits, m):
    fn = "w2a8_matmul" if bits == 2 else "w4a8_matmul"
    got, want = _a8_both(fn, bits, 1024, 256, 32, m, SEED + 13 + m)
    assert counted == [("wg_chunk", torch.int8)]
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------------------
# (c) the route each gate picks
# ---------------------------------------------------------------------------

I8, BF = torch.int8, torch.bfloat16

# (bits, K, N, group size, M, act_quant) -> the wrappers called, with the x
# dtype they got; [] is the weight-only route without a kernel (the dequant
# path, or the dense bf16 product of grouped weights at M >= 256)
ROUTES = [
    ((4, 1024, 256, None, 256, True), [("w4a8", I8)]),
    ((4, 1024, 256, None, 255, True), []),              # below 256: weight-only
    ((4, 1024, 256, None, 8, True), [("w4_gemv", BF)]),
    ((4, 1024, 256, None, 8, "all"), [("w4a8", I8)]),
    ((4, 1024, 384, None, 256, True), []),              # N % 256
    ((4, 768, 256, None, 8, "all"), [("w4_gemv", BF)]),  # K % 512
    ((8, 1024, 256, None, 256, True), [("w8a8", I8)]),
    ((8, 768, 384, None, 300, True), [("w8a8", I8)]),
    ((8, 1024, 256, None, 8, "all"), [("w8_gemv", BF)]),  # INT8 needs M >= 256
    ((8, 9216, 256, None, 256, True), []),              # K > 8192
    ((8, 1024, 200, None, 256, True), []),              # N % 128
    ((2, 1024, 256, None, 8, "all"), [("w2a8", I8)]),
    ((2, 1024, 384, None, 300, True), [("w2a8", I8)]),
    ((2, 768, 256, None, 8, "all"), []),                # K % 512
    ((2, 1024, 256, 32, 8, "all"), [("wg_chunk", I8)]),
    ((2, 1024, 256, 32, 64, "all"), [("wg_chunk", I8)]),
    ((2, 1024, 256, 32, 65, "all"), []),                # 96 rows > M_MAX
    ((2, 1024, 256, 32, 256, True), []),                # dense bf16 product
    ((4, 1024, 256, 32, 33, "all"), [("wg_chunk", I8)]),
    ((4, 1024, 256, 32, 8, True), [("wg_chunk", BF)]),  # below 256
    ((4, 512, 256, 16, 8, "all"), [("w4_grouped", BF)]),  # gs % 32
    ((2, 512, 256, 16, 8, "all"), []),                  # no chunk kernel
    ((8, 1024, 256, 32, 256, True), []),                # grouped INT8
]


@pytest.mark.parametrize("shape,calls", ROUTES, ids=[str(r[0]) for r in ROUTES])
def test_act_quant_routes(counted, shape, calls):
    bits, k, n, gs, m, aq = shape
    x, _, tq = _both(bits, k, n, gs, m, SEED + 5)
    y = TL.quantized_matmul(_t(x), tq, torch.float32, act_quant=aq)
    assert counted == calls
    assert y.shape == (m, n) and torch.isfinite(y).all()
    # within the per-token int8 error of the weight-only result
    ref = TL._matmul_dequant(_t(x), tq, torch.float32)
    scale = float(ref.abs().max())
    assert float((y - ref).abs().max()) <= 3e-2 * scale


# ---------------------------------------------------------------------------
# (d) quantized_matmul(act_quant=...) against the JAX package's
# ---------------------------------------------------------------------------

# Where both JAX routes quantize, against JAX's (CPU) act_quant route:
# channelwise atol 1e-4, rtol 1e-5 (exact integer products in both);
# grouped atol 2e-2, rtol 2e-2 (the chunk kernel's f32 group sums).
@pytest.mark.parametrize("bits,k,gs,m,aq,tol", [
    (4, 1024, None, 256, True, 1e-4), (4, 1024, None, 8, "all", 1e-4),
    (8, 512, None, 300, True, 1e-4), (2, 1024, None, 8, "all", 1e-4),
    (2, 1024, None, 256, True, 1e-4), (2, 1024, 32, 8, "all", 2e-2),
    (4, 2048, 64, 16, "all", 2e-2)])
def test_act_quant_matches_jax(bits, k, gs, m, aq, tol):
    x, jq, tq = _both(bits, k, 256, gs, m, SEED + 7 + m)
    want = np.asarray(JL.quantized_matmul(jnp.asarray(x), jq, jnp.float32,
                                          act_quant=aq))
    got = TL.quantized_matmul(_t(x), tq, torch.float32, act_quant=aq)
    np.testing.assert_allclose(got.numpy(), want, atol=tol,
                               rtol=tol if tol > 1e-4 else 1e-5)


# Where the reference's accelerator route declines, the port runs the
# weight-only route on the unquantized x (ROADMAP.md section 3): against
# JAX's act_quant=False.  Grouped at 64 < M < 256 and INT8 at K > 8192 take
# the f32 dequant path (atol 2e-2, rtol 1e-2); grouped at M >= 256 the
# dense product against the bf16 weight (atol 5e-2, rtol 2e-2, as
# tests/test_torch_weights.py's dense-route test).
@pytest.mark.parametrize("bits,k,gs,m,tol", [
    (2, 1024, 32, 96, (2e-2, 1e-2)), (4, 1024, 32, 96, (2e-2, 1e-2)),
    (2, 1024, 32, 256, (5e-2, 2e-2)), (4, 1024, 32, 256, (5e-2, 2e-2)),
    (8, 9216, None, 256, (2e-2, 1e-2))])
def test_declined_act_quant_is_weight_only(bits, k, gs, m, tol):
    x, jq, tq = _both(bits, k, 256, gs, m, SEED + 9 + m)
    want = np.asarray(JL.quantized_matmul(jnp.asarray(x), jq, jnp.float32,
                                          act_quant=False))
    got = TL.quantized_matmul(_t(x), tq, torch.float32, act_quant="all")
    np.testing.assert_allclose(got.numpy(), want, atol=tol[0], rtol=tol[1])
    np.testing.assert_array_equal(
        got.numpy(), TL.quantized_matmul(_t(x), tq, torch.float32).numpy())


# ---------------------------------------------------------------------------
# (e) the model with the config flags
# ---------------------------------------------------------------------------

# Whole-model logits: max |port - jax| <= 5e-2 * max |jax|.  Per-token int8
# activations add rounding noise that any upstream difference (the two
# packages' bf16 attention paths) draws anew: each package's logits move by
# 1.4-3.5% of their maximum when the flags are set, and the port and JAX
# differ by as much (3.4% measured), where tests/test_torch_model.py's
# LOGIT_TOL of 1.5e-2 covers the weight-only model.  The grouped-MLP case
# also carries the deliberate divergence at prefill (the port's weight-only
# route where the reference's CPU fallback quantizes).
AQ_LOGIT_TOL = 5e-2

# The tiny config widened to head_dim 128 with K % 512 and N % 256 at every
# projection, so the a8 gates take them; the prefill is 2 x 256 rows
MODEL_CASES = {
    "int4_act_quant_prefill": (dict(act_quant_prefill=True), dict(bits=4)),
    "int2_act_quant_decode": (dict(act_quant_decode=True), dict(bits=2)),
    "int2_g32_mlp_act_quant_decode": (
        dict(act_quant_decode=True),
        dict(bits=4, overrides={k: (2, 32) for k in ("w1", "w3", "w2")})),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_act_quant_matches_jax(case):
    flags, qkw = MODEL_CASES[case]
    jcfg = JM.LlamaConfig(vocab_size=256, d_model=512, n_layers=2,
                          n_heads=4, n_kv_heads=2, d_ff=1024,
                          max_seq_len=512, **flags)
    jfloat = JM.init_params(jcfg, jax.random.key(SEED))
    jparams = JM.quantize_params(jfloat, quantize_lm_head=True, **qkw)
    cfg = convert.config_from_jax(jcfg)
    assert (cfg.act_quant_prefill, cfg.act_quant_decode) == (
        jcfg.act_quant_prefill, jcfg.act_quant_decode)
    params = convert.params_from_jax(jparams, device=CPU)
    rng = np.random.default_rng(SEED)
    toks = jnp.asarray(rng.integers(1, cfg.vocab_size, (2, 256 + 3)),
                       jnp.int32)
    got = _run_port(cfg, params, toks, 3)
    want = _run_jax(jcfg, jparams, toks, 3, jit=True)
    assert np.isfinite(got).all() and got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= AQ_LOGIT_TOL, err
    top2 = np.sort(want, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > AQ_LOGIT_TOL * np.abs(
        want).max()
    assert (got.argmax(-1) == want.argmax(-1))[decisive].all()

    # greedy tokens from a 260-token prompt, under the near-tie guard
    prompt = [int(t) for t in rng.integers(1, cfg.vocab_size, 260)]
    n_new = 4

    def greedy(run_prefill, run_decode):
        logits, state = run_prefill(prompt)
        out = []
        for i in range(n_new):
            out.append(int(np.argmax(np.asarray(logits)[0])))
            if len(out) < n_new:
                logits, state = run_decode(out[-1], len(prompt) + i, state)
        return out

    def jax_prefill(p):
        cache = JM.init_kv_cache(jcfg, 1, max_len=jcfg.max_seq_len)
        return JM.prefill(jcfg, jparams, jnp.asarray([p], jnp.int32), cache)

    def jax_decode(tok, pos, cache):
        return JM.decode_step(jcfg, jparams, jnp.asarray([tok], jnp.int32),
                              jnp.asarray([pos], jnp.int32), cache)

    def port_prefill(p):
        cache = TM.init_kv_cache(cfg, 1, max_len=cfg.max_seq_len, device=CPU)
        return TM.prefill(cfg, params, torch.tensor([p], dtype=torch.int32),
                          cache)

    def port_decode(tok, pos, cache):
        return TM.decode_step(cfg, params, torch.tensor([tok], dtype=torch.int32),
                              torch.tensor([pos], dtype=torch.int32), cache)

    want = greedy(jax_prefill, jax_decode)
    got = greedy(port_prefill, port_decode)
    assert_tokens_match_guarded(
        lambda t: JM.forward(jcfg, jparams, t)[0], prompt, got, want, case)
