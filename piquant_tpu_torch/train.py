"""Data-parallel training with quantized gradient synchronization
(counterpart of piquant_tpu/train.py).

The gradients of a data-parallel step ride the quantized ring all-reduce
(parallel/collectives.py): uint8 codes and a per-chunk scale on the wire
in place of f32, stochastic rounding keeping the sum unbiased across
steps.  ZeRO-1/2 shards the optimizer state and the gradient reduction
over the dp axis.

    opt = Optimizer(torch.optim.Adam, lr=3e-3)
    step = make_train_step(loss_fn, opt, mesh, "dp", grad_wire="uint8")
    opt_state = opt.init(params)
    params, opt_state, loss = step(params, opt_state, batch, generator)

Where the reference runs one SPMD program whose `jax.grad` GSPMD has
already summed over dp, each rank here computes the gradient of the mean
loss over its own rows of the batch (rows d B / dp .. (d + 1) B / dp, as
`P("dp")` shards them), and the sync averages the ranks' gradients: with
`grad_wire=None` exactly, which is the reference's value-preserving
result.  The mesh axis takes the two forms of `parallel/mesh.py`:
  * a `StackedAxis`: every rank runs in this process, one after the other,
    and its gradients are stacked `[P, ...]` for the collectives; the
    synced replicas are bit-identical (the all-gather sends each shard's
    codes unchanged), and the update is applied once;
  * a process group: each process takes its own rows of the (global)
    batch, syncs its gradient with the others' and applies the update.
The returned loss is the mean over the whole batch.

The optimizer is an elementwise `torch.optim` class with its kwargs
(`Adam`, `AdamW`, `SGD`: the reference takes optax); `Optimizer.init`
builds its state as a tree of tensors (each leaf's state dict, as the torch
optimizer's own first step would make it), which the checkpoint saves.
Parameters and state are updated in place: at Llama-3-8B's width a copy
of either is 6-12 GB.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from piquant_tpu_torch.parallel.collectives import (quantized_all_gather,
                                                    quantized_all_reduce,
                                                    quantized_reduce_scatter)
from piquant_tpu_torch.parallel.mesh import StackedAxis
from piquant_tpu_torch.utils.tree import flatten

SMALL_LEAF = 1024  # fewer values a rank: an exact mean (the wire saves noise)
_ZERO_PAD = 1024   # per-leaf flat pad quantum of ZeRO, times dp


class Optimizer:
    """An elementwise torch optimizer class and its kwargs, applied to a
    list of tensors with state kept outside it (the counterpart of an optax
    transform's init / update)."""

    KINDS = (torch.optim.Adam, torch.optim.AdamW, torch.optim.SGD)

    def __init__(self, cls, **kwargs):
        if cls not in self.KINDS:
            raise ValueError(f"{cls.__name__}: the training step takes the "
                             "elementwise Adam, AdamW or SGD")
        if (cls is torch.optim.SGD and kwargs.get("momentum", 0)
                and kwargs.get("dampening", 0)):
            raise ValueError("SGD with momentum and dampening: its first "
                             "step copies the gradient, which a zero state "
                             "does not reproduce")
        self.cls, self.kwargs = cls, kwargs
        # the defaults the torch class fills in, for the state's keys
        self.defaults = cls([torch.zeros(1)], **kwargs).defaults

    def init(self, params) -> List[dict]:
        """One state dict per leaf of `params`, in leaf order: what the
        torch class's first step creates (Adam / AdamW: a step count and
        zero moments; SGD: a zero momentum buffer, or nothing)."""
        out = []
        for p in flatten(params)[0]:
            st = {}
            if self.cls is torch.optim.SGD:
                if self.defaults["momentum"]:
                    st["momentum_buffer"] = torch.zeros_like(p)
            else:
                st["step"] = torch.tensor(
                    0.0, dtype=(torch.float64 if torch.get_default_dtype()
                                == torch.float64 else torch.float32))
                st["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                if self.defaults["amsgrad"]:
                    st["max_exp_avg_sq"] = torch.zeros_like(p)
            out.append(st)
        return out

    def apply(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              state: List[dict]) -> None:
        """One update of `params` (in place) from `grads`, advancing
        `state` (in place)."""
        views = [p.detach() for p in params]
        opt = self.cls(views, **self.kwargs)
        for v, g, st in zip(views, grads, state):
            v.grad = g
            opt.state[v] = st
        with torch.no_grad():
            opt.step()
        for v in views:
            v.grad = None


def _ranks(axis) -> List[int]:
    """The axis indices of the ranks this process runs."""
    if isinstance(axis, StackedAxis):
        return list(range(axis.size))
    return [dist.get_rank(axis)]


def _rank_grads(loss_fn, params, batch, axis, dp: int, pad: int = 0):
    """(the mean loss over the batch, one f32 buffer a leaf [R, n] of the
    R local ranks' gradients, each flattened and zero-padded to a multiple
    of `pad`)."""
    leaves, unflatten = flatten(params)
    if batch.shape[0] % dp:
        raise ValueError(f"a batch of {batch.shape[0]} rows over dp {dp}")
    rb = batch.shape[0] // dp
    ranks = _ranks(axis)
    bufs = [torch.zeros((len(ranks), l.numel() + (-l.numel() % pad
                                                  if pad else 0)),
                        dtype=torch.float32, device=l.device)
            for l in leaves]
    loss = None
    for r, d in enumerate(ranks):
        views = [l.detach().requires_grad_() for l in leaves]
        with torch.enable_grad():
            lr = loss_fn(unflatten(views), batch[d * rb:(d + 1) * rb])
            grads = torch.autograd.grad(lr, views, allow_unused=True)
        for buf, g, l in zip(bufs, grads, leaves):
            if g is not None:
                buf[r, :l.numel()] = g.reshape(-1)
        del grads
        lr = lr.detach().float()
        loss = lr if loss is None else loss + lr
    if not isinstance(axis, StackedAxis):
        dist.all_reduce(loss, group=axis)
    return loss / dp, bufs


def _leaf_generators(generator: Optional[torch.Generator], n: int):
    """One generator a leaf, each seeded by a draw from `generator` (where
    the reference splits its key); None without one."""
    if generator is None:
        return [None] * n
    seeds = torch.randint(0, 2**62, (n,), generator=generator,
                          device=generator.device, dtype=torch.int64)
    return [torch.Generator().manual_seed(int(s)) for s in seeds.tolist()]


def _exact_sum(x: torch.Tensor, axis) -> torch.Tensor:
    """The ranks' sum of x [R, ...] (every rank's row)."""
    if isinstance(axis, StackedAxis):
        return x.sum(0, keepdim=True).expand_as(x)
    y = x.clone()
    dist.all_reduce(y, group=axis)
    return y


def _sync(x: torch.Tensor, axis, dp: int, wire, round_mode, gen):
    """The ranks' mean of x [R, n] f32: exact under SMALL_LEAF values a
    rank or without a wire, else the quantized all-reduce divided by dp."""
    if wire is None or x.shape[1] < SMALL_LEAF:
        return _exact_sum(x, axis) / dp
    if isinstance(axis, StackedAxis):
        summed = quantized_all_reduce(x, axis, wire, round_mode,
                                      generator=gen)
    else:
        summed = quantized_all_reduce(x[0], axis, wire, round_mode,
                                      generator=gen)[None]
    return summed.div_(dp)


def quantized_grad_sync(grads: Any, mesh, dp_axis: str = "dp",
                        wire: Optional[str] = "uint8",
                        round_mode: str = "stochastic", *,
                        generator: Optional[torch.Generator] = None) -> Any:
    """Mean-reduce a gradient tree across `dp_axis` through the quantized
    ring all-reduce (wire None: exactly).  Over a StackedAxis each leaf is
    stacked [P, ...] (row d rank d's gradient) and every row of the result
    holds the mean; over a process group each leaf is this rank's gradient.
    Leaves under SMALL_LEAF values a rank take an exact mean: quantizing
    them saves nothing."""
    dp = mesh.shape[dp_axis]
    if dp == 1:
        return grads
    axis = mesh.axis(dp_axis)
    stacked = isinstance(axis, StackedAxis)
    leaves, unflatten = flatten(grads)
    gens = _leaf_generators(generator, len(leaves))
    out = []
    for g, gen in zip(leaves, gens):
        rows = g.float().reshape(g.shape[0] if stacked else 1, -1)
        mean = _sync(rows, axis, dp, wire, round_mode, gen)
        out.append(mean.reshape(g.shape).to(g.dtype))
    return unflatten(out)


def make_train_step(
    loss_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    optimizer: Optimizer,
    mesh,
    dp_axis: str = "dp",
    grad_wire: Optional[str] = "uint8",     # None: the exact mean
    round_mode: str = "stochastic",
) -> Callable:
    """Build step(params, opt_state, batch, generator=None) -> (params,
    opt_state, loss): each rank's gradient over its rows, the quantized DP
    sync (one generator a leaf drawn from `generator` for stochastic
    rounding), the optimizer's update in place.  `opt_state` is
    `optimizer.init(params)`."""
    dp = mesh.shape[dp_axis]
    axis = mesh.axis(dp_axis)

    def step(params, opt_state, batch, generator=None):
        leaves = flatten(params)[0]
        loss, bufs = _rank_grads(loss_fn, params, batch, axis, dp)
        gens = _leaf_generators(generator if grad_wire else None,
                                len(leaves))
        grads = []
        for i, (leaf, gen) in enumerate(zip(leaves, gens)):
            mean = (bufs[i] if dp == 1 else
                    _sync(bufs[i], axis, dp, grad_wire, round_mode, gen))
            bufs[i] = None        # the rank buffers go leaf by leaf
            grads.append(mean[0].reshape(leaf.shape).to(leaf.dtype).clone())
            del mean
        optimizer.apply(leaves, grads, opt_state)
        return params, opt_state, loss

    return step


# ---------------------------------------------------------------------------
# ZeRO-sharded optimizer (stage 1/2)
# ---------------------------------------------------------------------------

def make_zero_train_step(
    loss_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    optimizer: Optimizer,
    mesh,
    dp_axis: str = "dp",
    grad_wire: Optional[str] = "uint8",     # None: an exact reduce-scatter
    round_mode: str = "stochastic",
    param_wire: Optional[str] = None,       # quantize the param all-gather
) -> Tuple[Callable, Callable]:
    """ZeRO-1/2 (Rajbhandari et al., 2019) on the quantized ring wire,
    returning (init_fn, step_fn):

        state = init_fn(params)
        params, state, loss = step_fn(params, state, batch, generator)

    Each leaf is flattened and zero-padded to a multiple of dp * 1024.
    Its gradient takes ONE quantized reduce-scatter (or an exact one under
    grad_wire=None); rank d then holds the sum of chunk (d + 1) mod dp
    under the quantized wire (the ring's rotation) and chunk d under the
    exact one, and applies the optimizer to that 1/dp shard of the leaf
    and of its state; the updated shards come back by an all-gather
    (quantized under `param_wire`), the +1 rotation undone.  The optimizer
    state exists only as shards: `state` is one list of per-leaf state
    dicts a rank of this process (stacked: every rank's), each tensor of
    1/dp of the padded leaf."""
    dp = mesh.shape[dp_axis]
    axis = mesh.axis(dp_axis)
    stacked = isinstance(axis, StackedAxis)
    quantum = dp * _ZERO_PAD

    def init_fn(params):
        shards = [torch.empty((l.numel() + -l.numel() % quantum) // dp,
                              dtype=torch.float32, device=l.device)
                  for l in flatten(params)[0]]
        return [optimizer.init(shards) for _ in _ranks(axis)]

    def gather(shards: torch.Tensor, gen) -> torch.Tensor:
        """[R, s] updated shards in holder order -> [dp, s] every holder's."""
        s = shards.shape[1]
        if param_wire is not None:
            full = quantized_all_gather(shards if stacked else shards[0],
                                        axis, param_wire, "nearest",
                                        generator=gen)
            return (full[0] if stacked else full).reshape(dp, s)
        if stacked:
            return shards
        parts = [torch.empty_like(shards[0]) for _ in range(dp)]
        dist.all_gather(parts, shards[0].contiguous(), group=axis)
        return torch.stack(parts)

    def step_fn(params, state, batch, generator=None):
        leaves = flatten(params)[0]
        ranks = _ranks(axis)
        loss, bufs = _rank_grads(loss_fn, params, batch, axis, dp, quantum)
        gens = _leaf_generators(generator, len(leaves))
        sizes = [b.shape[1] // dp for b in bufs]
        gshards, pshards = [], []
        for i, (leaf, gen) in enumerate(zip(leaves, gens)):
            s, g = sizes[i], bufs[i]
            if grad_wire is None:
                tot = _exact_sum(g, axis)[0]
                own = ranks
                gs = torch.stack([tot[d * s:(d + 1) * s] for d in own]) / dp
            else:
                rs = quantized_reduce_scatter(g if stacked else g[0], axis,
                                              grad_wire, round_mode,
                                              generator=gen)
                own = [(d + 1) % dp for d in ranks]
                gs = rs.reshape(len(ranks), s).div_(dp)
            bufs[i] = None
            flat = leaf.detach().reshape(-1).float()
            flat = torch.nn.functional.pad(flat, (0, s * dp - flat.numel()))
            pshards.append(torch.stack([flat[d * s:(d + 1) * s]
                                        for d in own]))
            gshards.append(gs)
        for r in range(len(ranks)):
            optimizer.apply([p[r] for p in pshards], [g[r] for g in gshards],
                            state[r])
        del gshards
        with torch.no_grad():
            for leaf, p, gen in zip(leaves, pshards, gens):
                full = gather(p, gen)
                if grad_wire is not None:   # undo the +1 ring rotation
                    full = torch.roll(full, 1, 0)
                leaf.copy_(full.reshape(-1)[:leaf.numel()]
                           .reshape(leaf.shape))
        return params, state, loss

    return init_fn, step_fn
