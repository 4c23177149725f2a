"""Fused quantized ring all-reduce (counterpart of
piquant_tpu/parallel/rdma_ring.py).

The reference fuses the whole ring, the remote copies over ICI included,
into one Pallas kernel a device: P-1 reduce-scatter hops that each quantize
the running partial to symmetric int8 (one f32 absmax scale a chunk), send
codes and scale to the right neighbour and dequant-ADD the received chunk
into the own addend, then an all-gather that quantizes each reduced chunk
ONCE at its owner and forwards the codes, so every replica is
bit-identical.  On Hopper the sends are `torch.distributed` operations
outside the kernels, and each hop's compute is one launch of
ops/cuda/ring.py (`ring_hop`: dequant-ADD, absmax, quantize; then
`ring_gather`: dequantize all P chunks):
  * over a process group a rank makes P `ring_hop` launches, sends its wire
    row (codes and scales, one buffer) right after each of the first P-1
    (one `batch_isend_irecv` pair a hop), forwards the owners' rows P-1
    hops and makes one `ring_gather` launch;
  * stacked in one process (a `StackedAxis`, or the P = 2 loopback of
    `rdma_ring_selftest`), one launch covers every rank: rank r reads rank
    r-1's row of the previous hop's send buffer (two buffers by parity, as
    the kernel's `send_c`), so a hop copies nothing; in loopback a rank's
    left neighbour is itself.
Chunking is the reference's exactly, since the quantization granularity
depends on it: chunks padded to multiples of 1,024 values, buckets of
P * max_chunk_elems values, the last, ragged bucket with its own chunk
size (each run of buckets one launch).
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from piquant_tpu_torch._device import DeviceLike, resolve_device
from piquant_tpu_torch.ops.cuda import ring as R
from piquant_tpu_torch.parallel.collectives import exchange
from piquant_tpu_torch.parallel.mesh import Axis, Mesh, StackedAxis

_LANE = 128


def _ring_stacked(rows: torch.Tensor, p: int, segs: List[R.Segment],
                  nbytes: int, loopback: bool = False) -> torch.Tensor:
    """Every rank of the ring stacked in rows [P, n] (loopback: the one
    rank [1, n] of a ring of 2) -> [rows, n] f32 replicas."""
    nr = rows.shape[0]
    bufs = torch.empty((2, nr, nbytes), dtype=torch.uint8, device=rows.device)
    out = torch.empty(rows.shape, dtype=torch.float32, device=rows.device)
    for hop in range(p):
        for seg in segs:
            R.ring_hop(rows, seg, p, hop, bufs[hop % 2],
                       None if hop == 0 else bufs[(hop - 1) % 2],
                       0, 0 if loopback else 1)
    for seg in segs:
        R.ring_gather(bufs[(p - 1) % 2], seg, p, out, loopback)
    return out


def _ring_group(row: torch.Tensor, group: dist.ProcessGroup,
                segs: List[R.Segment], nbytes: int) -> torch.Tensor:
    """This rank's addend [1, n] over a process group -> [1, n] f32."""
    p, me = dist.get_world_size(group), dist.get_rank(group)
    dev = row.device
    send = torch.empty((1, nbytes), dtype=torch.uint8, device=dev)
    recv = torch.empty_like(send)
    owned = torch.empty((p, nbytes), dtype=torch.uint8, device=dev)
    for hop in range(p):
        # the last hop quantizes the reduced chunk into this rank's row of
        # the all-gather's buffer
        dst = owned[me:me + 1] if hop == p - 1 else send
        for seg in segs:
            R.ring_hop(row, seg, p, hop, dst, None if hop == 0 else recv, me)
        if hop < p - 1:
            exchange(send, recv, group)        # ONE send per hop
    src = me
    for _ in range(p - 1):                     # forward the owners' rows
        exchange(owned[src], owned[(src - 1) % p], group)
        src = (src - 1) % p
    out = torch.empty(row.shape, dtype=torch.float32, device=dev)
    for seg in segs:
        R.ring_gather(owned, seg, p, out)
    return out


def rdma_all_reduce_shard(x: torch.Tensor, axis: Axis, *,
                          max_chunk_elems: int = 65536) -> torch.Tensor:
    """Int8 ring all-reduce of this rank's addend `x` (any shape, f32 or
    bf16) over `axis`; returns the sum in f32, x's shape.  Stacked: x
    [P, ...] holds every rank's addend and the result every rank's
    replica.  Quantization granularity is per (bucket, ring chunk): a
    smaller max_chunk_elems means finer scales."""
    if max_chunk_elems % R.QUANTUM:
        raise ValueError(f"max_chunk_elems must be a multiple of "
                         f"{R.QUANTUM}, got {max_chunk_elems}")
    if isinstance(axis, StackedAxis):
        axis.check(x)
        rows = x.reshape(axis.size, -1).float().contiguous()
        segs, nbytes = R.segments(rows.shape[1], axis.size, max_chunk_elems)
        return _ring_stacked(rows, axis.size, segs, nbytes).reshape(x.shape)
    row = x.reshape(1, -1).float().contiguous()
    segs, nbytes = R.segments(row.shape[1], dist.get_world_size(axis),
                              max_chunk_elems)
    return _ring_group(row, axis, segs, nbytes).reshape(x.shape)


def rdma_quantized_all_reduce(x: torch.Tensor, mesh: Mesh,
                              axis_name: str) -> torch.Tensor:
    """Stacked-convention wrapper (the calling style of `quantized_psum`):
    x [P, ...], row d rank d's addend -> the replicated quantized sum of
    the rows, x.shape[1:].  Over processes each rank takes its own row."""
    if not (x.dim() and x.shape[0] == mesh.shape[axis_name]):
        raise ValueError(
            "rdma_quantized_all_reduce expects x stacked over the mesh axis")
    axis = mesh.axis(axis_name)
    if isinstance(axis, StackedAxis):
        return rdma_all_reduce_shard(x, axis)[0]
    return rdma_all_reduce_shard(x[dist.get_rank(axis)], axis)


def rdma_ring_selftest(rows: int = 256, device: DeviceLike = None) -> float:
    """One-device smoke of the ring's kernels: a P = 2 LOOPBACK ring (every
    send targets self) over this device's addend of (2, rows, 128) values
    from seed 0.  It reduces the device's own two chunks, so out[j] ~=
    x[0] + x[1] for both chunks j.  Returns the max abs error against the
    f32 sum, asserted within 2.5 * absmax / 127 (two quantizations and the
    forward)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((2, rows, _LANE), generator=gen, device=dev)
    csize = rows * _LANE
    seg = R.Segment(0, 1, csize, 2 * csize, 0)
    out = _ring_stacked(x.reshape(1, -1), 2, [seg], seg.wire_bytes,
                        loopback=True).reshape(2, rows, _LANE)
    want = x[0] + x[1]
    err = float((out - want[None]).abs().max())
    scale = float(want.abs().max()) / 127.0
    assert err <= 2.5 * scale, (err, scale)
    return err
