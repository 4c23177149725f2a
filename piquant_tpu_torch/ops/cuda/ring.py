"""The compute of the fused symmetric-int8 ring all-reduce (counterpart of
piquant_tpu/parallel/rdma_ring.py: `_ring_kernel`, reached through
`_pallas_ring`).

The TPU kernel runs the whole ring in one program, RDMA included.  Here the
hops between ranks stay on the host (parallel/rdma_ring.py sends the wire
rows with torch.distributed, or, with every rank stacked on one card, reads
the left neighbour's row), and each hop's compute is one launch:
  * `ring_hop`: for every (rank row, bucket) chunk, v = own chunk + the
    received codes * scale (nothing received at hop 0), then
    scale = max(absmax(v) / 127, 1e-30) and
    codes = clamp(round(v / scale), -127, 127) (half to even, a true
    division), written into the rank's wire row;
  * `ring_gather`: out = codes * scale of every chunk's owner, for the P
    chunks of every bucket, into `nrep` replica rows.
Both launch the hand-written kernels (csrc/ring.cu) on CUDA tensors and run
`ring_hop_plain` / `ring_gather_plain` on CPU tensors.  `hop_plan` picks
`ring_hop`'s path for a chunk size: the chunk held on chip across a
thread-block cluster, or, past ONCHIP_MAX values, read twice.
`ring_plain` is the whole ring (the reference's schedule, bucketing
included) in plain PyTorch, written rank by rank like the reference tests'
numpy model; it is what the kernels' results are held against.

A `Segment` is a run of buckets of one chunk size in a rank's flat addend
(x_off: its first element; nb buckets of P chunks of csize elements, of
which `valid` a bucket are real, the rest zero padding; w_off: its first
byte in a wire row, which holds the nb * csize int8 codes and then nb f32
scales).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from piquant_tpu_torch.ops.cuda import _build

QUANTUM = 1024      # chunks are padded to multiples of 8 x 128 values
_QMAX = 127.0
_FLOOR = 1e-30
HOP_THREADS = 512   # threads of a ring_hop block
HOP_VALS = (4, 8, 16, 32)   # values a thread holds on chip (the instances)
CLUSTERS = (1, 2, 4, 8)     # blocks a chunk (portable cluster sizes)
PREF_CLUSTER = 4    # the cluster a chunk is spread over before vals grows
PASS_UNROLL = 4     # groups a thread a step on the two-pass path
ONCHIP_MAX = CLUSTERS[-1] * HOP_THREADS * HOP_VALS[-1]   # 131,072 values


@dataclasses.dataclass(frozen=True)
class Segment:
    x_off: int
    nb: int
    csize: int
    valid: int
    w_off: int

    @property
    def wire_bytes(self) -> int:
        return self.nb * (self.csize + 4)


@dataclasses.dataclass(frozen=True)
class HopPlan:
    vals: int       # values a thread holds on chip; 0: the two-pass path
    cluster: int    # blocks a chunk


def hop_plan(csize: int) -> HopPlan:
    """ring_hop's launch for chunks of csize values (a multiple of 4).  Up
    to ONCHIP_MAX a chunk stays in registers: the fewest values a thread
    (HOP_VALS) that cover it with PREF_CLUSTER blocks, then the smallest
    cluster that covers it at those values.  Past ONCHIP_MAX the two-pass
    path on clusters of 8 blocks."""
    if csize > ONCHIP_MAX:
        return HopPlan(0, CLUSTERS[-1])
    per = -(-csize // (HOP_THREADS * PREF_CLUSTER))
    vals = next((v for v in HOP_VALS if v >= per), HOP_VALS[-1])
    return HopPlan(vals, next(c for c in CLUSTERS
                              if c * HOP_THREADS * vals >= csize))


def hop_groups(plan: HopPlan, csize: int) -> torch.Tensor:
    """The groups of 4 chunk elements (group g: elements 4 g .. 4 g + 3)
    that ring_hop's threads take under `plan`, as csrc/ring.cu orders them:
    [cluster rank, thread, slot] -> g, or -1 where a slot holds none.  On
    chip block k's thread t holds groups (k * vals / 4 + s) * 512 + t; on
    the two-pass path it takes k * 512 + t + s * cluster * 512, PASS_UNROLL
    slots a step."""
    ng = csize // 4
    k = torch.arange(plan.cluster)[:, None, None]
    t = torch.arange(HOP_THREADS)[None, :, None]
    if plan.vals:
        slot = torch.arange(plan.vals // 4)[None, None, :]
        g = (k * (plan.vals // 4) + slot) * HOP_THREADS + t
    else:
        step = plan.cluster * HOP_THREADS
        slots = PASS_UNROLL * -(-ng // (PASS_UNROLL * step))
        g = k * HOP_THREADS + t + torch.arange(slots)[None, None, :] * step
    return torch.where(g < ng, g, -1)


def _round_up(n: int, q: int) -> int:
    return -(-n // q) * q


def segments(n: int, p: int, max_chunk_elems: int
             ) -> Tuple[List[Segment], int]:
    """The reference's bucketing of an n-element addend over a ring of p
    (rdma_ring.py:198-211): buckets of p * max_chunk_elems values, the
    last, ragged one (or a lone one of n <= p * max_chunk_elems) with its
    own chunk size, ceil(m / p) rounded up to QUANTUM.  -> (segments, bytes
    of a wire row)."""
    per_call = p * max_chunk_elems

    def one(x_off: int, m: int, w_off: int) -> Segment:
        return Segment(x_off, 1, _round_up(-(-m // p), QUANTUM), m, w_off)

    if n <= per_call:
        segs = [one(0, n, 0)]
    else:
        nfull, rem = divmod(n, per_call)
        segs = [Segment(0, nfull, max_chunk_elems, per_call, 0)]
        if rem:
            segs.append(one(nfull * per_call, rem, segs[0].wire_bytes))
    return segs, sum(s.wire_bytes for s in segs)


def _wire_views(wire: torch.Tensor, seg: Segment):
    """(codes [rows, nb, csize] int8, scales [rows, nb] f32) views of a
    segment's part of the wire rows [rows, bytes]."""
    rows = wire.shape[0]
    part = wire[:, seg.w_off:seg.w_off + seg.wire_bytes]
    codes = part[:, :seg.nb * seg.csize].view(torch.int8)
    scales = part[:, seg.nb * seg.csize:].contiguous().view(torch.float32)
    return codes.reshape(rows, seg.nb, seg.csize), scales


def _padded(x: torch.Tensor, seg: Segment, p: int) -> torch.Tensor:
    """A segment of the rows of x [rows, n] as [rows, nb, p, csize], zero
    padded past `valid`."""
    total = (seg.nb - 1) * p * seg.csize + seg.valid
    part = x[:, seg.x_off:seg.x_off + total]
    part = torch.nn.functional.pad(part, (0, seg.nb * p * seg.csize - total))
    return part.reshape(x.shape[0], seg.nb, p, seg.csize)


def _quantize(v: torch.Tensor):
    """Symmetric int8 over the last axis: (codes int8, scale f32).  Both
    divisions are by tensors: PyTorch turns a CUDA tensor's division by a
    Python number into a multiplication by its reciprocal, which is not
    the kernel's (or numpy's) IEEE division."""
    amax = v.abs().amax(dim=-1)
    scale = torch.clamp(amax / amax.new_tensor(_QMAX), min=_FLOOR)
    codes = torch.clamp(torch.round(v / scale[..., None]), -_QMAX, _QMAX)
    return codes.to(torch.int8), scale


def ring_hop_plain(x: torch.Tensor, seg: Segment, p: int, hop: int,
                   send: torch.Tensor, recv: Optional[torch.Tensor] = None,
                   my0: int = 0, shift: int = 0) -> None:
    """Hop `hop` of every rank row of x [rows, n] f32: row r is rank
    my0 + r, quantizes its chunk (my0 + r - hop) mod p plus what it
    received (recv row (r - shift) mod rows; None at hop 0) and writes the
    codes and scales into its row of `send` [rows, bytes] u8."""
    rows = x.shape[0]
    xs = _padded(x, seg, p)
    c = (my0 + torch.arange(rows) - hop) % p
    v = xs[torch.arange(rows), :, c]                   # [rows, nb, csize]
    if recv is not None:
        rc, rs = _wire_views(recv.roll(shift, 0), seg)
        v = v + rc.float() * rs[..., None]
    codes, scale = _quantize(v)
    part = send[:, seg.w_off:seg.w_off + seg.wire_bytes]
    part[:, :seg.nb * seg.csize] = codes.reshape(rows, -1).view(torch.uint8)
    part[:, seg.nb * seg.csize:] = scale.view(torch.uint8)


def ring_gather_plain(wire: torch.Tensor, seg: Segment, p: int,
                      out: torch.Tensor, loopback: bool = False) -> None:
    """out [nrep, n] f32: each replica row's segment gets chunk c of every
    bucket as codes * scale of wire row (c - 1) mod p, the rank that
    reduced it (row 0 in loopback)."""
    codes, scales = _wire_views(wire, seg)
    owner = (torch.zeros(p, dtype=torch.long) if loopback
             else (torch.arange(p) - 1) % p)
    vals = codes[owner].float() * scales[owner][..., None]  # [p, nb, csize]
    vals = vals.transpose(0, 1).reshape(-1)
    total = (seg.nb - 1) * p * seg.csize + seg.valid
    out[:, seg.x_off:seg.x_off + total] = vals[:total]


def _check(name: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device != dev or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be 2-D, contiguous and "
                             "on one device")


def _vec(x: torch.Tensor, seg: Segment) -> int:
    return int(x.data_ptr() % 16 == 0 and x.shape[1] % 4 == 0
               and seg.x_off % 4 == 0)


def _words(seg: Segment, *wires: torch.Tensor) -> bool:
    """The kernels read and write codes 4 bytes at a time."""
    return not (seg.csize % 4 or seg.w_off % 4 or any(
        w.data_ptr() % 4 or w.shape[1] % 4 for w in wires))


def _hop_launch(x: torch.Tensor, seg: Segment, p: int, hop: int,
                send: torch.Tensor, recv: Optional[torch.Tensor], my0: int,
                shift: int, plan: HopPlan) -> None:
    err = _build.library().pq_ring_hop(
        x.data_ptr(), None if recv is None else recv.data_ptr(),
        send.data_ptr(), seg.x_off, x.shape[1], seg.w_off, send.shape[1],
        seg.csize, seg.valid, seg.nb, p, x.shape[0], hop, my0, shift,
        _vec(x, seg), plan.vals, plan.cluster, _build.stream_ptr(x))
    _build.check(err, "ring_hop")


def ring_hop(x: torch.Tensor, seg: Segment, p: int, hop: int,
             send: torch.Tensor, recv: Optional[torch.Tensor] = None,
             my0: int = 0, shift: int = 0) -> None:
    """Kernel wrapper; see `ring_hop_plain` for the function."""
    if not x.is_cuda:
        return ring_hop_plain(x, seg, p, hop, send, recv, my0, shift)
    _build.no_grad("ring_hop", "16c", x)
    if x.dtype != torch.float32 or send.dtype != torch.uint8 or (
            recv is not None and (recv.dtype != torch.uint8
                                  or recv.shape != send.shape)):
        raise TypeError("ring_hop: f32 x and u8 wire rows expected")
    _check("ring_hop", x, send, *(() if recv is None else (recv,)))
    if send.shape[0] != x.shape[0] or not _words(
            seg, send, *(() if recv is None else (recv,))):
        raise ValueError("ring_hop: one wire row a rank row, chunks of a "
                         "multiple of 4 values, wire rows 4-byte aligned")
    _hop_launch(x, seg, p, hop, send, recv, my0, shift, hop_plan(seg.csize))
    ring_hop.launches += 1


def ring_gather(wire: torch.Tensor, seg: Segment, p: int, out: torch.Tensor,
                loopback: bool = False) -> None:
    """Kernel wrapper; see `ring_gather_plain` for the function."""
    if not wire.is_cuda:
        return ring_gather_plain(wire, seg, p, out, loopback)
    _build.no_grad("ring_gather", "16c", out)
    if wire.dtype != torch.uint8 or out.dtype != torch.float32:
        raise TypeError("ring_gather: u8 wire rows and f32 out expected")
    _check("ring_gather", wire, out)
    if wire.shape[0] != (1 if loopback else p) or not _words(seg, wire):
        raise ValueError("ring_gather: one wire row a rank (one in "
                         "loopback), chunks of a multiple of 4 values, wire "
                         "rows 4-byte aligned")
    err = _build.library().pq_ring_gather(
        wire.data_ptr(), out.data_ptr(), seg.x_off, out.shape[1], seg.w_off,
        wire.shape[1], seg.csize, seg.valid, seg.nb, p, out.shape[0],
        int(loopback), _vec(out, seg), _build.stream_ptr(wire))
    _build.check(err, "ring_gather")
    ring_gather.launches += 1


def ring_attributes(kind: str, plan: HopPlan = HopPlan(0, 1),
                    device: Optional[int] = None) -> tuple:
    """pq_ring_attributes of a 16-byte ring kernel on `device`:
    (registers, local (spill) bytes, blocks an SM holds, clusters of
    plan.cluster blocks the card holds at once).  kind "hop" (plan.vals 0:
    the two-pass path) or "gather" (plan ignored)."""
    import ctypes

    out = (ctypes.c_int * 4)()
    k, vals, cl = (0, plan.vals, plan.cluster) if kind == "hop" else (1, 0, 1)
    with torch.cuda.device(device):
        _build.check(_build.library().pq_ring_attributes(k, vals, cl, out),
                     "pq_ring_attributes")
    return tuple(out)


ring_hop.launches = 0
ring_gather.launches = 0


def ring_plain(x: torch.Tensor, max_chunk_elems: int = 65536,
               loopback: bool = False) -> torch.Tensor:
    """The whole ring over the rows of x [P, n] (row d: rank d's addend)
    -> [P, n] f32, every row rank d's replica of the int8-ring sum.  Rank
    by rank and hop by hop, as the reference tests' `_simulate` models the
    TPU kernel, with the reference's bucketing.  In loopback x is [1, n],
    the one rank of a ring of 2 whose neighbour is itself."""
    p = 2 if loopback else x.shape[0]
    n = x.shape[1]
    per_call = p * max_chunk_elems
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    for off in range(0, n, per_call):
        m = min(per_call, n - off)
        csize = _round_up(-(-m // p), QUANTUM)
        piece = torch.nn.functional.pad(x[:, off:off + m].float(),
                                        (0, p * csize - m))
        chunks = piece.reshape(x.shape[0], p, csize)
        ranks = range(x.shape[0])
        acc = {d: chunks[d, d] for d in ranks}
        for s in range(p - 1):
            wires = {d if loopback else (d + 1) % p: _quantize(acc[d])
                     for d in ranks}
            for d in ranks:
                codes, scale = wires[d]
                acc[d] = chunks[d, (d - s - 1) % p] + codes.float() * scale
        full = torch.empty(p, csize, dtype=torch.float32, device=x.device)
        for d in ranks:
            codes, scale = _quantize(acc[d])
            deq = codes.float() * scale
            if loopback:
                full[:] = deq
            else:
                full[(d + 1) % p] = deq
        out[:, off:off + m] = full.reshape(-1)[:m]
    return out
