"""Worker processes of the port's multi-process tests: a gloo world on the
CPU, one process a rank, runs the port's mesh and collectives on inputs the
test wrote, and saves what it saw for the test to check.  It imports
nothing of JAX: the test holds the results against the JAX package."""

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 8


def spawn(fn, tmp_path, inputs: dict, world: int = WORLD) -> list:
    """Run fn(rank, inputs) -> dict on `world` gloo ranks; -> the ranks'
    saved results in rank order."""
    np.savez(tmp_path / "inputs.npz", **inputs)
    mp.spawn(_main, args=(fn, str(tmp_path), world), nprocs=world, join=True)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _main(rank: int, fn, tmp: str, world: int) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world)
    try:
        inputs = dict(np.load(os.path.join(tmp, "inputs.npz")))
        torch.save(fn(rank, inputs), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


class SendSpy:
    """Counts the sends (isend P2POps) of dist.batch_isend_irecv while it
    is installed."""

    def __init__(self):
        self.sends = 0
        self._orig = dist.batch_isend_irecv

    def __enter__(self):
        def spy(ops):
            self.sends += sum(op.op is dist.isend for op in ops)
            return self._orig(ops)
        dist.batch_isend_irecv = spy
        return self

    def __exit__(self, *exc):
        dist.batch_isend_irecv = self._orig


def collectives(rank: int, inputs: dict) -> dict:
    from piquant_tpu_torch.parallel import collectives as C
    from piquant_tpu_torch.parallel import make_mesh, quantized_psum

    out = {}
    mesh = make_mesh([("x", -1)])
    grid = make_mesh([("dp", 2), ("tp", -1)])
    out["shape"] = dict(mesh.shape), dict(grid.shape)
    out["groups"] = {name: dist.get_process_group_ranks(grid.axis(name))
                     for name in ("dp", "tp")}
    out["coords"] = {name: dist.get_rank(grid.axis(name))
                     for name in ("dp", "tp")}
    x = mesh.axis("x")
    t = lambda a: torch.from_numpy(a[rank])          # noqa: E731

    wires = []
    quantize_chunk = C._quantize_chunk

    def record(chunk, dt, round_mode, gen):
        wire = quantize_chunk(chunk, dt, round_mode, gen)
        wires.append((chunk.numpy().copy(), wire.numpy().copy()))
        return wire

    C._quantize_chunk = record
    try:
        with SendSpy() as spy:
            out["rs"] = C.quantized_reduce_scatter(
                t(inputs["rs"]), x, "uint8", "nearest").numpy()
        out["rs_sends"], out["rs_wires"] = spy.sends, wires
    finally:
        C._quantize_chunk = quantize_chunk
    with SendSpy() as spy:
        out["ag"] = C.quantized_all_gather(t(inputs["ag"]), x, "uint8",
                                           "nearest").numpy()
    out["ag_sends"] = spy.sends
    for q in ("uint8", "uint4"):
        out[f"ar_{q}"] = C.quantized_all_reduce(t(inputs["ar"]), x, q,
                                                "nearest").numpy()
    gen = torch.Generator().manual_seed(0)
    out["stoch"] = C.quantized_all_reduce(t(inputs["stoch"]), x, "uint8",
                                          "stochastic", generator=gen).numpy()
    out["psum"] = quantized_psum(torch.from_numpy(inputs["psum"]), mesh, "x",
                                 "uint8", "nearest").numpy()
    out["psum_tp"] = quantized_psum(torch.from_numpy(inputs["psum_tp"]), grid,
                                    "tp", "uint8", "nearest").numpy()
    return out


def ring(rank: int, inputs: dict) -> dict:
    from piquant_tpu_torch.parallel import (make_mesh, rdma_all_reduce_shard,
                                            rdma_quantized_all_reduce)

    mesh = make_mesh([("x", -1)])
    out = {}
    for name in ("s4096", "s1000", "s16x257", "sim"):
        with SendSpy() as spy:
            out[name] = rdma_quantized_all_reduce(
                torch.from_numpy(inputs[name]), mesh, "x").numpy()
        out[name + "_sends"] = spy.sends
    out["bucketed"] = rdma_all_reduce_shard(
        torch.from_numpy(inputs["bucketed"][rank]), mesh.axis("x"),
        max_chunk_elems=1024).numpy()
    return out


def lm_loss(cfg):
    """The next-token loss of tests/test_train.py, on the port: the mean
    negative log-likelihood of batch[:, 1:] under the logits of
    batch[:, :-1]."""
    from piquant_tpu_torch.models import llama as TM

    def loss_fn(p, batch):
        logits, _ = TM.forward(cfg, p, batch[:, :-1])
        lp = torch.log_softmax(logits.float(), dim=-1)
        return -lp.gather(-1, batch[:, 1:, None].long()).mean()
    return loss_fn


TRAIN_RUNS = (("exact", None, False), ("uint8", "uint8", False),
              ("zero_uint8", "uint8", True))


def train_runs(batch: np.ndarray, mesh, steps: int = 3) -> dict:
    """The tiny f32 Llama (vocab 64, init_params from seed 0) trained with
    Adam on `batch` over the mesh's dp axis: {name: (losses, leaves)} for
    the replicated step under the exact and the uint8 wire and the uint8
    ZeRO step (stochastic rounding, a generator a step seeded 100 + i)."""
    from piquant_tpu_torch import train as T
    from piquant_tpu_torch.models import llama as TM
    from piquant_tpu_torch.utils import tree

    cfg = TM.LlamaConfig.tiny(vocab=64, dtype=torch.float32)
    b = torch.from_numpy(batch)
    out = {}
    for name, wire, zero in TRAIN_RUNS:
        opt = T.Optimizer(torch.optim.Adam, lr=3e-3)
        params = TM.init_params(cfg, seed=0, device="cpu")
        if zero:
            init, step = T.make_zero_train_step(lm_loss(cfg), opt, mesh,
                                                "dp", grad_wire=wire)
        else:
            init = opt.init
            step = T.make_train_step(lm_loss(cfg), opt, mesh, "dp",
                                     grad_wire=wire)
        state, losses = init(params), []
        for i in range(steps):
            params, state, loss = step(params, state, b,
                                       torch.Generator().manual_seed(100 + i))
            losses.append(float(loss))
        out[name] = (np.array(losses),
                     [x.numpy().copy() for x in tree.leaves(params)])
    return out


def train(rank: int, inputs: dict) -> dict:
    from piquant_tpu_torch.parallel import make_mesh

    return train_runs(inputs["batch"], make_mesh([("dp", -1)]))
