"""Ragged (megablocks-style) MoE expert GEMMs of
piquant_tpu/ops/pallas/qmatmul.py, with the TPU kernels they replace:

    wq_ragged          _wq_ragged_kernel          channelwise INT2/INT4/INT8 stacks, bf16 x
    wq_ragged_grouped  _wq_ragged_grouped_kernel  grouped stacks, bf16 x
    wq_ragged_a8       _wq_ragged_a8_kernel       channelwise INT2/INT4 stacks, int8 x

x holds the (token, expert) assignments sorted by expert and padded so each
ROW_BLOCK-row block belongs to one expert, `block_expert[i]` (quant/moe.py
builds the routing); a block multiplies by its expert's packed weight.  The
first two wrappers launch the bf16 tensor-core kernels of
csrc/qmatmul_ragged.cu, the third the int8 template of csrc/qmatmul_a8.cu
with the expert lookup, on CUDA tensors, and count the launch in
`.launches`; on CPU tensors they run `<name>_plain`, the same function in
plain PyTorch.  The kernels take whole 128-row blocks (the routing's bm),
N % 128 and K/P % 32; the wrappers raise on anything else.

The dispatch functions keep the reference's semantic gates (bits, the
packed rows, groups that straddle a plane, the side streams' shape, N a
multiple of the smallest TPU column tile) and drop its VMEM budgets
(W_BLOCK_VMEM_LIMIT and the bn it picks), which declined the INT8 stack of
Mixtral's w2 (K = 14336): the port runs that one ragged.
"""

from __future__ import annotations

from typing import Optional

import torch

from piquant_tpu_torch.ops.cuda import _build
from piquant_tpu_torch.ops.cuda import qmatmul as _qmm
from piquant_tpu_torch.ops.cuda.qmatmul import PLANES, code_planes

ROW_BLOCK = 128   # rows of a routing block (quant/moe.py bm) and of a tile
_COLS = 128       # output columns of a tile
_STEP = 32        # packed rows a pipeline step stages


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _runs(block_expert: torch.Tensor, m: int, n_experts: int):
    """(expert, row indices) of each expert that owns rows: the padding
    blocks past the last expert's end belong to the last expert, as in the
    routing."""
    bm = m // block_expert.numel()
    row_e = block_expert.long().repeat_interleave(bm)
    for e in range(n_experts):
        idx = (row_e == e).nonzero()[:, 0]
        if idx.numel():
            yield e, idx


def wq_ragged_plain(x: torch.Tensor, data: torch.Tensor, scale: torch.Tensor,
                    zs: torch.Tensor, xsum: torch.Tensor,
                    block_expert: torch.Tensor, out_dtype) -> torch.Tensor:
    """x [M, K] bf16, data [E, K/P, N] uint8 (P = 4 INT2 split-quarter, 2
    INT4 split-half, 1 INT8), scale / zs [E, N] f32 (zs = zp * scale), xsum
    [M, 1] f32, block_expert [M / bm] int32 -> [M, N]: for the rows of
    expert e, the P plane products of e's raw codes (bf16 operands, f32
    accumulation), then acc * scale[e] - xsum * zs[e]
    (`_wq_ragged_kernel`)."""
    m, k = x.shape
    n_e, rows, n = data.shape
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    for e, idx in _runs(block_expert, m, n_e):
        xe = x[idx].float()
        acc = None
        for p, plane in enumerate(code_planes(data[e], k // rows)):
            part = xe[:, p * rows:(p + 1) * rows] @ plane.float()
            acc = part if acc is None else acc + part
        out[idx] = (acc * scale[e] - xsum[idx] * zs[e]).to(out_dtype)
    return out


def wq_ragged_grouped_plain(x: torch.Tensor, data: torch.Tensor,
                            scale: torch.Tensor, zp: torch.Tensor, gs: int,
                            block_expert: torch.Tensor,
                            out_dtype) -> torch.Tensor:
    """x [M, K] bf16, data [E, K/P, N] uint8, scale [E, G, N] f32, zp [E,
    G, N] int32 (G = K / gs, in natural group order) -> [M, N]: expert e's
    weight dequantized to bf16 as (code - bf16(zp)) * bf16(scale), rounded
    once, then one product with f32 accumulation; no rank-1 fold
    (`_wq_ragged_grouped_kernel`)."""
    m, k = x.shape
    n_e, rows, n = data.shape
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    for e, idx in _runs(block_expert, m, n_e):
        s = scale[e].to(torch.bfloat16).repeat_interleave(gs, dim=0)
        z = zp[e].to(torch.bfloat16).repeat_interleave(gs, dim=0)
        codes = torch.cat(code_planes(data[e], k // rows)).to(torch.bfloat16)
        w = (codes - z) * s
        out[idx] = (x[idx].float() @ w.float()).to(out_dtype)
    return out


def wq_ragged_a8_plain(xq: torch.Tensor, xs: torch.Tensor, data: torch.Tensor,
                       scale: torch.Tensor, zs: torch.Tensor,
                       xsum: torch.Tensor, block_expert: torch.Tensor,
                       out_dtype) -> torch.Tensor:
    """xq [M, K] int8, xs [M, 1] f32, data [E, K/P, N] uint8 (INT2 or
    INT4), scale / zs [E, N] f32, xsum [M, 1] f32 (row sums of xq) -> [M,
    N]: for the rows of expert e, acc = xq @ codes exactly in int32, then
    (acc * scale[e] - xsum * zs[e]) * xs, as `w4a8_plain` / `w2a8_plain`
    (`_wq_ragged_a8_kernel`)."""
    m, k = xq.shape
    n_e, rows, n = data.shape
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    for e, idx in _runs(block_expert, m, n_e):
        out[idx] = _qmm._a8_plain(xq[idx], xs[idx], data[e], scale[e], zs[e],
                                  xsum[idx], out_dtype, k // rows, 0)
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_ragged(name: str, x: torch.Tensor, data: torch.Tensor,
                  block_expert: torch.Tensor, out_dtype, x_dtype) -> int:
    """Shared checks of the three wrappers; returns the planes P."""
    check = _qmm._check
    m, k = x.shape
    check(name, out_dtype in (torch.bfloat16, torch.float32), TypeError,
          f"out dtype {out_dtype} not supported")
    check(name, x.dtype == x_dtype and data.dtype == torch.uint8
          and block_expert.dtype == torch.int32, TypeError,
          f"x {x_dtype}, uint8 codes and int32 block_expert expected")
    check(name, data.dim() == 3, what="codes must be [E, K/P, N]")
    n_e, rows, n = data.shape
    planes = k // rows if rows else 0
    check(name, planes in (1, 2, 4) and rows * planes == k
          and rows % _STEP == 0 and n % _COLS == 0,
          what=f"unsupported shape k={k} rows={rows} n={n}")
    check(name, m == ROW_BLOCK * block_expert.numel(),
          what=f"m={m} is not {ROW_BLOCK} rows per block_expert entry")
    _qmm._check_operands(name, x, data, block_expert)
    return planes


def _launch(name: str, entry: str, ptrs: tuple, x: torch.Tensor, n: int,
            ints: tuple, out_dtype) -> torch.Tensor:
    m, k = x.shape
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    err = getattr(_build.library(), entry)(
        *(t.data_ptr() for t in ptrs), out.data_ptr(), m, k, n, *ints,
        int(out_dtype == torch.bfloat16), _build.stream_ptr(x))
    _build.check(err, name)
    return out


def _check_side(name, n_e, n, *tensors) -> None:
    _qmm._check(name, all(t.dtype == torch.float32 for t in tensors),
                TypeError, "f32 side streams expected")
    _qmm._check(name, all(t.numel() == n_e * n for t in tensors),
                what="scale / zs must be [E, N]")


def wq_ragged(x, data, scale, zs, xsum, block_expert,
              out_dtype) -> torch.Tensor:
    """Kernel wrapper; see `wq_ragged_plain` for the function."""
    if not x.is_cuda:
        return wq_ragged_plain(x, data, scale, zs, xsum, block_expert,
                               out_dtype)
    name = "wq_ragged"
    planes = _check_ragged(name, x, data, block_expert, out_dtype,
                           torch.bfloat16)
    n_e, _, n = data.shape
    _check_side(name, n_e, n, scale, zs)
    _qmm._check(name, xsum.dtype == torch.float32, TypeError,
                "xsum f32 expected")
    _qmm._check(name, xsum.numel() == x.shape[0], what="xsum must be [M, 1]")
    _qmm._check_operands(name, x, scale, zs, xsum)
    out = _launch(name, "pq_wq_ragged",
                  (x, data, scale, zs, xsum, block_expert), x, n, (planes,),
                  out_dtype)
    wq_ragged.launches += 1
    return out


def wq_ragged_grouped(x, data, scale, zp, gs: int, block_expert,
                      out_dtype) -> torch.Tensor:
    """Kernel wrapper; see `wq_ragged_grouped_plain` for the function."""
    if not x.is_cuda:
        return wq_ragged_grouped_plain(x, data, scale, zp, gs, block_expert,
                                       out_dtype)
    name = "wq_ragged_grouped"
    planes = _check_ragged(name, x, data, block_expert, out_dtype,
                           torch.bfloat16)
    n_e, rows, n = data.shape
    _qmm._check(name, gs > 0 and rows % gs == 0,
                what=f"group size {gs} does not tile the planes of "
                     f"K={x.shape[1]}")
    _qmm._check(name, scale.dtype == torch.float32 and zp.dtype == torch.int32,
                TypeError, "scale f32, zp int32 expected")
    _qmm._check(name, tuple(scale.shape) == (n_e, x.shape[1] // gs, n)
                == tuple(zp.shape), what="scale / zp must be [E, K/gs, N]")
    _qmm._check_operands(name, x, scale, zp)
    out = _launch(name, "pq_wq_ragged_grouped",
                  (x, data, scale, zp, block_expert), x, n, (planes, gs),
                  out_dtype)
    wq_ragged_grouped.launches += 1
    return out


def wq_ragged_a8(xq, xs, data, scale, zs, xsum, block_expert,
                 out_dtype) -> torch.Tensor:
    """Kernel wrapper; see `wq_ragged_a8_plain` for the function."""
    if not xq.is_cuda:
        return wq_ragged_a8_plain(xq, xs, data, scale, zs, xsum,
                                  block_expert, out_dtype)
    name = "wq_ragged_a8"
    planes = _check_ragged(name, xq, data, block_expert, out_dtype,
                           torch.int8)
    _qmm._check(name, planes in (2, 4) and xq.shape[1] % 256 == 0,
                what="INT2 / INT4 codes and K % 256 expected")
    n_e, _, n = data.shape
    _check_side(name, n_e, n, scale, zs)
    _qmm._check(name, xs.dtype == xsum.dtype == torch.float32, TypeError,
                "xs / xsum f32 expected")
    _qmm._check(name, xs.numel() == xsum.numel() == xq.shape[0],
                what="xs / xsum must be [M, 1]")
    _qmm._check_operands(name, xq, xs, scale, zs, xsum)
    out = _launch(name, "pq_wq_ragged_a8",
                  (xq, xs, data, scale, zs, xsum, block_expert), xq, n,
                  (planes,), out_dtype)
    wq_ragged_a8.launches += 1
    return out


wq_ragged.launches = wq_ragged_grouped.launches = wq_ragged_a8.launches = 0


# ---------------------------------------------------------------------------
# dispatch (the reference's entry points)
# ---------------------------------------------------------------------------

def _channel_side(stack):
    """scale and zs = zp * scale of a channelwise stack as [E, N] f32."""
    e, n = stack.n_experts, stack.n
    s = stack.scale.float().expand(e, 1, n)
    zs = stack.zero_point.float().expand(e, 1, n) * s
    return s.reshape(e, n).contiguous(), zs.reshape(e, n).contiguous()


def wq_ragged_matmul(x_sorted: torch.Tensor, stack, block_expert: torch.Tensor,
                     out_dtype=torch.bfloat16) -> Optional[torch.Tensor]:
    """x_sorted [M, K] @ the block's expert of `stack` -> [M, N]: channelwise
    or grouped INT2/INT4/INT8 stacks; None where the reference's
    `wq_ragged_matmul` declines on other than VMEM grounds."""
    if stack.bits not in (2, 4, 8):
        return None
    if stack.group_size is not None:
        return _wq_ragged_grouped(x_sorted, stack, block_expert, out_dtype)
    m, k = x_sorted.shape
    _, rows, n = stack.data.shape
    if (m % block_expert.numel() or n % _COLS
            or rows != k // PLANES[stack.bits]):
        return None
    scale, zs = _channel_side(stack)
    xsum = x_sorted.float().sum(dim=-1, keepdim=True)
    return wq_ragged(x_sorted.to(torch.bfloat16).contiguous(), stack.data,
                     scale, zs, xsum, block_expert, out_dtype)


def _wq_ragged_grouped(x_sorted, stack, block_expert,
                       out_dtype) -> Optional[torch.Tensor]:
    m, k = x_sorted.shape
    e, rows, n = stack.data.shape
    gs = stack.group_size
    planes = PLANES[stack.bits]
    if (m % block_expert.numel() or k % gs
            or (k // planes) % gs            # groups straddle a plane edge
            or tuple(stack.scale.shape) != (e, k // gs, n)
            or rows != k // planes or n % _COLS):
        return None
    return wq_ragged_grouped(x_sorted.to(torch.bfloat16).contiguous(),
                             stack.data, stack.scale.float().contiguous(),
                             stack.zero_point.to(torch.int32).contiguous(),
                             gs, block_expert, out_dtype)


def wq_ragged_matmul_a8(xq: torch.Tensor, xs: torch.Tensor, stack,
                        block_expert: torch.Tensor,
                        out_dtype=torch.bfloat16) -> Optional[torch.Tensor]:
    """Act-quant ragged expert matmul: xq [M, K] int8 with per-row scales
    xs [M, 1] against a channelwise INT2/INT4 stack; None where the
    reference's `wq_ragged_matmul_a8` declines on other than VMEM
    grounds."""
    if stack.bits not in (2, 4) or stack.group_size is not None:
        return None
    m, k = xq.shape
    _, rows, n = stack.data.shape
    if (m % block_expert.numel() or rows != k // PLANES[stack.bits]
            or n % _COLS):
        return None
    scale, zs = _channel_side(stack)
    xsum = xq.float().sum(dim=-1, keepdim=True)
    return wq_ragged_a8(xq, xs.float(), stack.data, scale, zs, xsum,
                        block_expert, out_dtype)
