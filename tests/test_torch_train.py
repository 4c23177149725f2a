"""The port's training step, ZeRO step and checkpoint
(piquant_tpu_torch/train.py, utils/checkpoint.py) against the JAX
package's on the CPU: the tiny f32 Llama of tests/test_train.py (vocab 64,
DP 4, a repeated batch of 8 x 17 tokens), the JAX weights carried across by
`convert.params_from_jax`.  JAX runs `make_train_step` on its 4-device CPU
mesh; the port runs its ranks stacked in one process
(`make_mesh([("dp", 4)], devices=["cpu"] * 4)`) and, once, over a
2-process gloo world against the same run stacked."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from piquant_tpu import train as JT
from piquant_tpu.models import llama as JM
from piquant_tpu.utils import checkpoint as JCK
from piquant_tpu_torch import convert, train as T
from piquant_tpu_torch.models import llama as TM
from piquant_tpu_torch.parallel import make_mesh
from piquant_tpu_torch.utils import checkpoint as CK
from piquant_tpu_torch.utils import tree
from tests import torch_dist_worker as W
from _torch_threads import one_thread  # noqa: F401

DP = 4
CPU = torch.device("cpu")
STEPS = 4
LR = 3e-3
# The two packages' gradients of one batch: attention rounds q, k, v, the
# probabilities and their cotangents to bf16 in both, at f32 inputs that
# part by an ulp (other summation orders), so a rounding can fall the other
# way: each leaf within 5e-3 of its largest |gradient| (1.5e-3 measured).
GRAD_RTOL = 5e-3
# Their exact-wire trajectories: Adam's first update is lr * sign(g), and
# later ones divide the moments by their own square roots, so an element
# whose gradient is near 0 can take another sign in the two runs and part
# by up to 2 lr a step; the rest stay at the gradients' parting.  Four
# steps of lr 3e-3: every element within 2 lr a step, the median within
# 1e-4 (8.6e-6 measured) and under 2% of the elements beyond it (0.7%
# measured); the losses within 2e-4 relative (5.1e-5 measured).
LOSS_RTOL = 2e-4


@pytest.fixture(scope="module")
def jmesh():
    return Mesh(np.array(jax.devices()[:DP]), ("dp",))


@pytest.fixture(scope="module")
def setup(jmesh):
    jcfg = JM.LlamaConfig.tiny(vocab=64, dtype=jnp.float32)
    jparams = jax.device_put(JM.init_params(jcfg, jax.random.key(0)),
                             NamedSharding(jmesh, P()))
    rng = np.random.default_rng(1)
    batch = rng.integers(0, 64, (DP * 2, 17)).astype(np.int32)
    return jcfg, jparams, convert.config_from_jax(jcfg), batch


def _jax_loss(jcfg):
    def loss_fn(p, batch):
        logits, _ = JM.forward(jcfg, p, batch[:, :-1])
        lp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(lp, batch[:, 1:, None], axis=-1)
        return nll.mean()
    return loss_fn


lm_loss = W.lm_loss


def _port_params(jparams):
    return convert.params_from_jax(jparams, device=CPU)


def _mesh(dp=DP):
    return make_mesh([("dp", dp)], devices=["cpu"] * dp)


def _run_port(setup, wire, steps=STEPS, zero=False, opt=None, seed=100):
    jcfg, jparams, cfg, batch = setup
    opt = opt or T.Optimizer(torch.optim.Adam, lr=LR)
    params = _port_params(jparams)
    if zero:
        init, step = T.make_zero_train_step(lm_loss(cfg), opt, _mesh(), "dp",
                                            grad_wire=wire)
        state = init(params)
    else:
        step = T.make_train_step(lm_loss(cfg), opt, _mesh(), "dp",
                                 grad_wire=wire)
        state = opt.init(params)
    b = torch.from_numpy(batch)
    losses = []
    for i in range(steps):
        gen = torch.Generator().manual_seed(seed + i)
        params, state, loss = step(params, state, b, gen)
        losses.append(float(loss))
    return losses, params, state


def _run_jax(setup, jmesh, zero=False):
    jcfg, jparams, cfg, batch = setup
    opt = optax.adam(LR)
    b = jax.device_put(jnp.asarray(batch), NamedSharding(jmesh, P("dp", None)))
    if zero:
        init, step = JT.make_zero_train_step(_jax_loss(jcfg), opt, jmesh,
                                             "dp", grad_wire=None)
        state, step = init(jparams), jax.jit(step)
    else:
        step = jax.jit(JT.make_train_step(_jax_loss(jcfg), opt, jmesh, "dp",
                                          grad_wire=None))
        state = opt.init(jparams)
    params, losses = jparams, []
    for _ in range(STEPS):
        params, state, loss = step(params, state, b)
        losses.append(float(loss))
    return losses, params


@pytest.fixture(scope="module")
def jax_exact(setup, jmesh):
    return _run_jax(setup, jmesh)


@pytest.fixture(scope="module")
def port_exact(setup):
    return _run_port(setup, None)


def _assert_trajectory(got, want, losses, want_losses, steps=STEPS):
    """The exact-wire bounds above: losses, and params element by element,
    in median and in share."""
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    g, w = tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    gaps = []
    for a, b in zip(g, w):
        gap = np.abs(a.numpy() - np.asarray(b))
        assert gap.max() <= 2 * LR * steps, gap.max()
        gaps.append(gap.reshape(-1))
    gaps = np.concatenate(gaps)
    assert np.median(gaps) <= 1e-4
    assert (gaps > 1e-4).mean() < 0.02


def test_grad_sync_exact_matches_jax_grad(setup):
    """Each rank's gradient over its rows, stacked and averaged by
    quantized_grad_sync without a wire, is the reference's gradient of the
    whole batch (GRAD_RTOL)."""
    jcfg, jparams, cfg, batch = setup
    want = jax.tree.leaves(jax.grad(_jax_loss(jcfg))(jparams,
                                                     jnp.asarray(batch)))
    leaves, unflatten = tree.flatten(_port_params(jparams))
    rows, per_rank = batch.shape[0] // DP, []
    for d in range(DP):
        views = [x.detach().requires_grad_() for x in leaves]
        loss = lm_loss(cfg)(unflatten(views),
                            torch.from_numpy(batch[d * rows:(d + 1) * rows]))
        per_rank.append(torch.autograd.grad(loss, views))
    stacked = [torch.stack(gs) for gs in zip(*per_rank)]
    got = T.quantized_grad_sync(stacked, _mesh(), "dp", wire=None)
    for g, w in zip(got, want):
        w = np.asarray(w)
        for r in range(DP):
            np.testing.assert_array_equal(g[r].numpy(), g[0].numpy())
        assert np.abs(g[0].numpy() - w).max() <= GRAD_RTOL * np.abs(w).max()


def test_exact_step_matches_jax(port_exact, jax_exact):
    losses, params, _ = port_exact
    want_losses, want_params = jax_exact
    assert losses[-1] < losses[0]
    _assert_trajectory(params, want_params, losses, want_losses)


def test_quantized_train_tracks_baseline(setup, port_exact, jax_exact):
    """tests/test_train.py's bounds: per-step losses within rtol / atol
    0.05 of the exact run's (the port's and JAX's), final params within
    0.3 of the largest baseline magnitude, leaf by leaf."""
    q_losses, q_params, _ = _run_port(setup, "uint8")
    base_losses, base_params, _ = port_exact
    assert q_losses[-1] < q_losses[0]
    np.testing.assert_allclose(q_losses, base_losses, rtol=0.05, atol=0.05)
    np.testing.assert_allclose(q_losses, jax_exact[0], rtol=0.05, atol=0.05)
    for a, b in zip(tree.leaves(q_params), tree.leaves(base_params)):
        denom = float(b.abs().max()) + 1e-6
        assert float((a - b).abs().max()) / denom < 0.3


def test_grad_sync_small_leaves_exact():
    """quantized_grad_sync: a leaf under 1024 values a rank takes the exact
    mean; a large one the quantized all-reduce, every row the mean within
    the uint8 wire's step; each leaf its own generator."""
    rng = np.random.default_rng(5)
    g = {"small": torch.from_numpy(rng.normal(size=(DP, 7, 9))
                                   .astype(np.float32)),
         "big": torch.from_numpy(rng.normal(size=(DP, 64, 64))
                                 .astype(np.float32))}
    out = T.quantized_grad_sync(g, _mesh(), "dp", "uint8", "stochastic",
                                generator=torch.Generator().manual_seed(0))
    mean = {k: v.mean(0) for k, v in g.items()}
    for r in range(DP):
        np.testing.assert_allclose(out["small"][r].numpy(),
                                   mean["small"].numpy(), rtol=1e-6,
                                   atol=1e-7)
        # 3 hops of a uint8 reduce-scatter and one all-gather, each within
        # one step of a chunk's range (at most 8 / 255 here), divided by 4
        np.testing.assert_allclose(out["big"][r].numpy(),
                                   mean["big"].numpy(), atol=4 * 8 / 255 / 4)
        np.testing.assert_array_equal(out["big"][r].numpy(),
                                      out["big"][0].numpy())
    assert T.quantized_grad_sync(g, _mesh(1), "dp") is g


def test_zero_exact_matches_replicated_and_jax(setup, jmesh, port_exact):
    """tests/test_train.py's bound for ZeRO against the replicated step
    (atol 2e-5, rtol 2e-4: sharding the optimizer reorganizes it), and the
    exact-wire trajectory bounds against JAX's ZeRO."""
    z_losses, z_params, _ = _run_port(setup, None, zero=True)
    for a, b in zip(tree.leaves(z_params), tree.leaves(port_exact[1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5,
                                   rtol=2e-4)
    j_losses, j_params = _run_jax(setup, jmesh, zero=True)
    _assert_trajectory(z_params, j_params, z_losses, j_losses)


def test_zero_state_is_sharded(setup):
    """Every rank's state holds 1/dp of each padded leaf (the step counts
    aside), and the ranks' shards together cover it once."""
    jcfg, jparams, cfg, batch = setup
    params = _port_params(jparams)
    init, _ = T.make_zero_train_step(lm_loss(cfg),
                                     T.Optimizer(torch.optim.Adam, lr=LR),
                                     _mesh(), "dp", grad_wire=None)
    state = init(params)
    assert len(state) == DP
    for leaf, *per_rank in zip(tree.leaves(params), *state):
        padded = leaf.numel() + (-leaf.numel() % (DP * 1024))
        for st in per_rank:
            for name in ("exp_avg", "exp_avg_sq"):
                assert st[name].numel() * DP == padded


def test_zero_quantized_wire_learns(setup, port_exact):
    """uint8 gradient wire, Adam (the reference's test takes its 8-bit Adam,
    which the port does not have yet): loss falls and tracks the exact
    run within tests/test_train.py's 0.05."""
    losses, _, _ = _run_port(setup, "uint8", zero=True, steps=STEPS)
    assert losses[-1] < losses[0], losses
    np.testing.assert_allclose(losses, port_exact[0], rtol=0.05, atol=0.05)


def test_zero_param_wire(setup, port_exact):
    """A uint8 all-gather of the updated shards: replicas become q(master),
    within one uint8 step of the exact run's (a shard's range holds the
    zero padding, so it spans 0 too)."""
    _, params, _ = _run_port(setup, None, zero=True, steps=1)
    opt = T.Optimizer(torch.optim.Adam, lr=LR)
    jcfg, jparams, cfg, batch = setup
    init, step = T.make_zero_train_step(lm_loss(cfg), opt, _mesh(), "dp",
                                        grad_wire=None, param_wire="uint8")
    qp = _port_params(jparams)
    qp, _, _ = step(qp, init(qp), torch.from_numpy(batch))
    for a, b in zip(tree.leaves(qp), tree.leaves(params)):
        rng = float(b.max().clamp(min=0) - b.min().clamp(max=0))
        assert float((a - b).abs().max()) <= rng / 255 + 1e-6


def test_checkpoint_restart_recovers_training(setup, tmp_path):
    """Save (params, opt_state) after 3 steps, drop the live state, restore
    into fresh templates and go on: after 6 steps the params are bit for
    bit those of the run without a break (replicated and ZeRO, uint8
    wire)."""
    jcfg, jparams, cfg, batch = setup
    b = torch.from_numpy(batch)
    for zero in (False, True):
        opt = T.Optimizer(torch.optim.Adam, lr=1e-3)
        if zero:
            init, step = T.make_zero_train_step(lm_loss(cfg), opt, _mesh(),
                                                "dp", grad_wire="uint8")
        else:
            init = opt.init
            step = T.make_train_step(lm_loss(cfg), opt, _mesh(), "dp",
                                     grad_wire="uint8")

        def run(p, s, lo, hi):
            for i in range(lo, hi):
                p, s, _ = step(p, s, b, torch.Generator().manual_seed(i))
            return p, s

        p0 = _port_params(jparams)
        want, _ = run(p0, init(p0), 0, 6)
        p = _port_params(jparams)
        p, s = run(p, init(p), 0, 3)
        ck = str(tmp_path / f"ck{zero}")
        CK.save_checkpoint(ck, {"params": p, "opt": s}, step=3)
        del p, s
        fresh = _port_params(jparams)
        restored, at = CK.restore_checkpoint(
            ck, {"params": fresh, "opt": init(fresh)})
        assert at == 3
        p, _ = run(restored["params"], restored["opt"], 3, 6)
        for x, y in zip(tree.leaves(p), tree.leaves(want)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("cls,kw", [
    (torch.optim.Adam, dict(lr=1e-2)),
    (torch.optim.Adam, dict(lr=1e-2, amsgrad=True, weight_decay=0.1)),
    (torch.optim.AdamW, dict(lr=1e-2, weight_decay=0.1)),
    (torch.optim.SGD, dict(lr=0.1, momentum=0.9, nesterov=True)),
    (torch.optim.SGD, dict(lr=0.1))])
def test_optimizer_matches_torch(cls, kw):
    """Optimizer's state built up front (init) and kept outside the torch
    optimizer steps the params bit for bit as the torch optimizer does
    with its own lazily made state."""
    rng = np.random.default_rng(7)
    p0 = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
          for s in ((5, 3), (7,))]
    grads = [[torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
              for x in p0] for _ in range(3)]
    mine = [x.clone() for x in p0]
    opt = T.Optimizer(cls, **kw)
    state = opt.init(mine)
    theirs = [x.clone().requires_grad_() for x in p0]
    ref = cls(theirs, **kw)
    for gs in grads:
        opt.apply(mine, gs, state)
        for t, g in zip(theirs, gs):
            t.grad = g.clone()
        ref.step()
    for a, b in zip(mine, theirs):
        assert torch.equal(a, b.detach())


def test_checkpoint_rejects_mismatched_template(tmp_path):
    CK.save_checkpoint(str(tmp_path / "c"), {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="mismatch"):
        CK.restore_checkpoint(str(tmp_path / "c"),
                              {"a": torch.zeros(3), "b": torch.zeros(2)})
    with pytest.raises(ValueError, match="mismatch"):
        CK.restore_checkpoint(str(tmp_path / "c"), {"a": torch.zeros(4)})


@pytest.mark.parametrize("form", ["f32", "bf16", "int4"])
def test_params_checkpoint_crosses_packages(form, tmp_path):
    """A params checkpoint written by the JAX package restores into the
    port's template bit for bit, and one written by the port into JAX's:
    f32 and bf16 trees, and INT4 quantized linears (their data, scale and
    zero point in the reference's pytree order)."""
    from piquant_tpu_torch.quant.linear import QuantizedLinear

    dt = jnp.float32 if form == "f32" else jnp.bfloat16
    jcfg = JM.LlamaConfig.tiny(vocab=64, dtype=dt)
    jparams = JM.init_params(jcfg, jax.random.key(3))
    if form == "int4":
        jparams = JM.quantize_params(jparams, bits=4)
    mine = convert.params_from_jax(jparams, device=CPU)
    if form == "int4":
        assert any(isinstance(x, QuantizedLinear)
                   for x in mine["layers"][0].values())
    JCK.save_checkpoint(str(tmp_path / "j"), jparams, step=7)
    template = tree.tree_map(torch.zeros_like, mine)
    got, at = CK.restore_checkpoint(str(tmp_path / "j"), template)
    assert at == 7
    for a, b in zip(tree.leaves(got), tree.leaves(mine)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    CK.save_checkpoint(str(tmp_path / "t"), mine, step=9)
    back, at = JCK.restore_checkpoint(
        str(tmp_path / "t"), jax.tree.map(jnp.zeros_like, jparams))
    assert at == 9
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_gloo_matches_stacked(setup, tmp_path):
    """A 2-process gloo world (one process a rank, its own rows of the
    batch) against the same two ranks stacked in this process: the replicated
    step under the exact and the stochastic uint8 wires and the uint8 ZeRO
    step, bit for bit (the same per-rank arithmetic, sums of two values,
    the collectives' wire bytes equal by construction)."""
    got = W.spawn(W.train, tmp_path, {"batch": setup[3]}, world=2)
    want = W.train_runs(setup[3], _mesh(2))
    for r in range(2):
        for name, (losses, leaves) in want.items():
            g_losses, g_leaves = got[r][name]
            np.testing.assert_array_equal(g_losses, losses)
            for a, b in zip(g_leaves, leaves):
                np.testing.assert_array_equal(a, b)
