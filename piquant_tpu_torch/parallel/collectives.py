"""Quantized ring collectives (counterpart of
piquant_tpu/parallel/collectives.py).

Ring reduce-scatter, all-gather and all-reduce whose every hop sends packed
low-bit codes (uint8 / int8 / uint4 / uint2 wire format) plus their
(scale, zero point), the receiver dequantizing with the ADD store operator
straight into its accumulator.  Each hop re-derives (scale, zero point)
from the chunk it is about to send, and the codes and both scalars travel
in ONE fused uint8 buffer, [packed codes | scale f32 | zero point i32],
byte for byte the reference's, so a hop is one send.  Quantize and
dequantize go through `piquant_tpu_torch.api`: on CUDA tensors the
hand-written kernels, on CPU tensors their plain versions.

Where JAX names an axis inside `shard_map`, these functions take the
mesh's handle of it (`Mesh.axis(name)`, parallel/mesh.py):
  * a `torch.distributed` process group: `x` is this rank's addend and a
    hop is one `dist.batch_isend_irecv` pair of the wire buffer (gloo for
    CPU tensors, NCCL for CUDA tensors, as the group was made);
  * a `StackedAxis`: `x` stacks every rank's addend over a leading
    dimension, results come back stacked the same way, and a hop is a roll
    of the stacked wire rows.
Stochastic rounding takes `generator=` in place of `key=`: one base seed is
drawn from it per call (every rank fed the same seed draws the same base),
and each (rank, hop) quantizes under its own seed derived from it, as the
reference folds the axis index and the hop into its key; the all-gather
derives its seeds at step 10,000.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from piquant_tpu_torch import api as _api
from piquant_tpu_torch.dtypes import QDType, dtype_of, packed_numel
from piquant_tpu_torch.parallel.mesh import Axis, Mesh, StackedAxis

_MASK = (1 << 64) - 1
_GATHER_STEP = 10_000


def _axis_size(axis: Axis) -> int:
    if isinstance(axis, StackedAxis):
        return axis.size
    return dist.get_world_size(axis)


def _rows(x: torch.Tensor, axis: Axis) -> Tuple[torch.Tensor, List[int]]:
    """x as rows [R, n], one a rank of this process, and the ranks' indices
    along the axis (all of them stacked; this process's over a group)."""
    if isinstance(axis, StackedAxis):
        axis.check(x)
        return x.reshape(axis.size, -1), list(range(axis.size))
    return x.reshape(1, -1), [dist.get_rank(axis)]


def _unrows(rows: torch.Tensor, axis: Axis) -> torch.Tensor:
    return rows if isinstance(axis, StackedAxis) else rows[0]


def exchange(send: torch.Tensor, recv: torch.Tensor,
             group: dist.ProcessGroup) -> None:
    """One ring hop over a process group: `send` goes to the right
    neighbour and the left neighbour's lands in `recv`, as one
    batch_isend_irecv pair, waited for."""
    p, me = dist.get_world_size(group), dist.get_rank(group)
    right = dist.get_global_rank(group, (me + 1) % p)
    left = dist.get_global_rank(group, (me - 1) % p)
    for work in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, right, group),
            dist.P2POp(dist.irecv, recv, left, group)]):
        work.wait()


def _send_recv(wires: torch.Tensor, axis: Axis) -> torch.Tensor:
    """One ring hop of the wire rows [R, W]: every rank sends to its right
    neighbour."""
    if isinstance(axis, StackedAxis):
        return torch.roll(wires, 1, 0)
    recv = torch.empty_like(wires)
    exchange(wires, recv, axis)
    return recv


def _mix(z: int) -> int:
    """splitmix64's finalizer."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def _base_seed(round_mode: str, generator: Optional[torch.Generator]
               ) -> Optional[int]:
    if round_mode != "stochastic" or generator is None:
        return None
    s = torch.randint(-(1 << 63), (1 << 63) - 1, (), generator=generator,
                      device=generator.device, dtype=torch.int64)
    return int(s) & _MASK


def _fold_seed(base: Optional[int], rank: int, step: int
               ) -> Optional[torch.Generator]:
    """The generator of one (rank, hop): a seed derived from the call's
    base (None without one, which stochastic rounding refuses)."""
    if base is None:
        return None
    seed = _mix(_mix(base ^ rank) ^ step) >> 1
    return torch.Generator().manual_seed(seed)


def _quantize_chunk(chunk: torch.Tensor, dt: QDType, round_mode: str,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    """Per-hop dynamic quantization of one chunk -> the fused wire buffer
    [packed codes | scale f32 as 4 bytes | zp i32 as 4 bytes], uint8."""
    if dt.storage.itemsize != 1:
        raise ValueError(
            f"quantized collectives use a byte wire format; got {dt.name} "
            f"(storage {dt.storage}) — use uint8/int8/uint4/uint2")
    scale, zp = _api.compute_quant_params(chunk, dt)
    packed = _api.quantize(chunk, scale, zp, dt, round_mode,
                           generator=generator)
    sb = scale.to(torch.float32).reshape(1).view(torch.uint8)
    zb = zp.to(torch.int32).reshape(1).view(torch.uint8)
    return torch.cat([packed.reshape(-1).view(torch.uint8), sb, zb])


def _wire_split(wire: torch.Tensor, numel: int, dt: QDType):
    """Fused wire buffer -> (packed, scale, zp)."""
    pb = packed_numel(numel, dt)
    packed = wire[:pb] if dt.is_packed else wire[:pb].view(dt.storage)
    scale = wire[pb:pb + 4].clone().view(torch.float32)
    zp = wire[pb + 4:pb + 8].clone().view(torch.int32)
    return packed, scale, zp


def _dequantize_chunk(packed, scale, zp, numel: int, dt: QDType, out_dtype,
                      *, add_to: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    if add_to is not None:
        acc = add_to.reshape(-1).clone()
        return _api.dequantize(packed, scale, zp, dt, out_dtype=out_dtype,
                               numel=numel, reduce_op="add", out=acc)
    return _api.dequantize(packed, scale, zp, dt, out_dtype=out_dtype,
                           numel=numel)


# ---------------------------------------------------------------------------
# ring reduce-scatter
# ---------------------------------------------------------------------------

def _reduce_scatter(rows: torch.Tensor, idx: List[int], axis: Axis,
                    dt: QDType, round_mode: str, base: Optional[int]
                    ) -> torch.Tensor:
    nper = rows.shape[1]
    p = _axis_size(axis)
    if nper % p:
        raise ValueError(f"x.size={nper} not divisible by axis size {p}")
    csize = nper // p
    chunks = rows.reshape(rows.shape[0], p, csize)
    odt = dtype_of(rows.dtype)
    acc = [chunks[r, d % p] for r, d in enumerate(idx)]
    for s in range(p - 1):
        wires = _send_recv(torch.stack([
            _quantize_chunk(acc[r], dt, round_mode, _fold_seed(base, d, s))
            for r, d in enumerate(idx)]), axis)        # ONE send per hop
        for r, d in enumerate(idx):
            packed, scale, zp = _wire_split(wires[r], csize, dt)
            # after the receive, rank d works on chunk (d - s - 1) mod p
            acc[r] = _dequantize_chunk(packed, scale, zp, csize, dt, odt,
                                       add_to=chunks[r, (d - s - 1) % p])
    # acc holds the full sum of chunk (d - (p-1)) mod p == (d + 1) mod p
    return torch.stack(acc)


def quantized_reduce_scatter(x: torch.Tensor, axis: Axis,
                             qdtype: Union[QDType, str] = "uint8",
                             round_mode: str = "stochastic", *,
                             generator: Optional[torch.Generator] = None
                             ) -> torch.Tensor:
    """Ring reduce-scatter with quantized hops.

    `x` is this rank's full-size local addend (stacked: every rank's,
    [P, ...]), with a size per rank that P divides.  Returns this rank's
    reduced shard of x.size / P elements: rank d holds the sum of chunk
    (d + 1) mod P.

    Schedule: at step s (s = 0..P-2) rank d quantizes its running partial
    for chunk (d - s) mod P and sends it right; it receives chunk
    (d - s - 1) mod P and dequant-ADDs its own addend into it."""
    dt = dtype_of(qdtype)
    rows, idx = _rows(x, axis)
    base = _base_seed(round_mode, generator)
    return _unrows(_reduce_scatter(rows, idx, axis, dt, round_mode, base),
                   axis)


# ---------------------------------------------------------------------------
# ring all-gather
# ---------------------------------------------------------------------------

def _all_gather(rows: torch.Tensor, idx: List[int], axis: Axis, dt: QDType,
                round_mode: str, base: Optional[int],
                shift: int = 0) -> torch.Tensor:
    """[R, P * csize]: rank k's shard at position (k + shift) mod P of every
    row, each dequantized into its place (no stacked copies: at a gradient
    of Llama-3-8B's embedding the rows alone are 8 GB)."""
    p = _axis_size(axis)
    nr, csize = rows.shape
    odt = dtype_of(rows.dtype)
    wire = torch.stack([
        _quantize_chunk(rows[r], dt, round_mode,
                        _fold_seed(base, d, _GATHER_STEP))
        for r, d in enumerate(idx)])
    out_wire = torch.zeros((nr, p) + wire.shape[1:], dtype=torch.uint8,
                           device=wire.device)
    src = list(idx)
    for s in range(p):
        for r in range(nr):
            out_wire[r, src[r]] = wire[r]
        if s == p - 1:
            break
        wire = _send_recv(wire, axis)                   # ONE send per hop
        # after a right-hop each rank holds its left neighbour's shard
        src = [(v - 1) % p for v in src]
    out = torch.empty((nr, p * csize), dtype=rows.dtype, device=rows.device)
    for r in range(nr):
        for k in range(p):
            at = (k + shift) % p
            out[r, at * csize:(at + 1) * csize] = _dequantize_chunk(
                *_wire_split(out_wire[r, k], csize, dt), csize, dt, odt)
    return out


def quantized_all_gather(shard: torch.Tensor, axis: Axis,
                         qdtype: Union[QDType, str] = "uint8",
                         round_mode: str = "nearest", *,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """Ring all-gather of per-rank shards with quantized hops.

    Each rank contributes `shard` (equal sizes; stacked: [P, ...]) and gets
    the concatenation ordered by rank index, P * shard.size values.  Each
    shard is quantized ONCE at its source and hops forward the bytes
    unchanged, so every rank reconstructs bit-identical values."""
    dt = dtype_of(qdtype)
    rows, idx = _rows(shard, axis)
    base = _base_seed(round_mode, generator)
    return _unrows(_all_gather(rows, idx, axis, dt, round_mode, base), axis)


# ---------------------------------------------------------------------------
# all-reduce = reduce-scatter + all-gather
# ---------------------------------------------------------------------------

def quantized_all_reduce(x: torch.Tensor, axis: Axis,
                         qdtype: Union[QDType, str] = "uint8",
                         round_mode: str = "stochastic", *,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """Quantized ring all-reduce (sum) of `x` across `axis`: a
    shape-preserving stand-in for a sum with ~bits/32 of the wire traffic
    (stacked: [P, ...] in, every rank's replica out)."""
    dt = dtype_of(qdtype)
    rows, idx = _rows(x, axis)
    p = _axis_size(axis)
    n = rows.shape[1]
    pad = -n % p
    if pad:
        rows = torch.nn.functional.pad(rows, (0, pad))
    base = _base_seed(round_mode, generator)
    shard = _reduce_scatter(rows, idx, axis, dt, round_mode, base)
    # the reduce-scatter leaves rank d holding chunk (d+1) mod p: the
    # all-gather places holder d's shard at chunk (d+1) mod p
    full = _all_gather(shard, idx, axis, dt, "nearest", base, shift=1)
    return _unrows(full[:, :n], axis).reshape(x.shape)


def quantized_psum(x: torch.Tensor, mesh: Mesh, axis_name: str,
                   qdtype: Union[QDType, str] = "uint8",
                   round_mode: str = "stochastic", *,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """quantized_all_reduce of per-rank addends stacked over the mesh axis:
    x [P, ...], row d rank d's addend; returns the quantized sum,
    x.shape[1:].  Over processes each rank takes its own row."""
    if not (x.dim() and x.shape[0] == mesh.shape[axis_name]):
        raise ValueError(
            "quantized_psum expects x stacked over the mesh axis: shape[0] "
            "== axis size")
    axis = mesh.axis(axis_name)
    if isinstance(axis, StackedAxis):
        return quantized_all_reduce(x, axis, qdtype, round_mode,
                                    generator=generator)[0]
    return quantized_all_reduce(x[dist.get_rank(axis)], axis, qdtype,
                                round_mode, generator=generator)
