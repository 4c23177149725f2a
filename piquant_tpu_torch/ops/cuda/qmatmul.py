"""INT4 weight-only GEMV for decode-sized M (counterpart of
piquant_tpu/ops/pallas/qmatmul.py: `quantized_matmul` dispatch for 4-bit
channelwise weights, `_w4_kernel` and `_w4_kernel_ksplit`).

`w4_gemv` launches the hand-written kernel (csrc/qmatmul_w4.cu) on CUDA
tensors and runs `w4_gemv_plain`, the same function in plain PyTorch, on
CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from piquant_tpu_torch.ops.cuda import _build

M_MAX = 64        # decode-sized M; larger M takes the dequant matmul path
_COLS = 128       # output columns per block (csrc/qmatmul_w4.cu)
_MT = 8           # x rows per block
_MAX_ROWS = 512   # packed K rows per block


def w4_gemv_plain(x2: torch.Tensor, data: torch.Tensor, scale: torch.Tensor,
                  zp: torch.Tensor, xsum: torch.Tensor,
                  out_dtype) -> torch.Tensor:
    """x2 [M, K] bf16, data [K/2, N] uint8, scale [N] f32, zp [N] int32,
    xsum [M, 1] f32 -> [M, N]: the two nibble-plane products with f32
    accumulation, then acc * scale - xsum * (zp * scale)."""
    kh = data.shape[0]
    lo = (data & 15).float()
    hi = (data >> 4).float()
    acc = x2[:, :kh].float() @ lo + x2[:, kh:].float() @ hi
    return (acc * scale - xsum * (zp.float() * scale)).to(out_dtype)


def split_k(m: int, k: int, n: int, sms: int):
    """(ksplit, rows per split): split K over blocks up to four blocks per
    SM (the kernel's register use lets four stay resident, so the grid is
    one wave), keeping >= 64 packed rows and <= 512 (the x staging bound)
    per split."""
    kh = k // 2
    blocks = (n // _COLS) * -(-m // _MT)
    want = max(1, 4 * sms // blocks)
    ksplit = max(-(-kh // _MAX_ROWS), min(want, max(1, kh // 64)))
    rows = -(-kh // ksplit)
    rows += -rows % 8
    return -(-kh // rows), rows


def w4_gemv(x2: torch.Tensor, data: torch.Tensor, scale: torch.Tensor,
            zp: torch.Tensor, xsum: torch.Tensor, out_dtype) -> torch.Tensor:
    """Kernel wrapper; see `w4_gemv_plain` for the function."""
    if not x2.is_cuda:
        return w4_gemv_plain(x2, data, scale, zp, xsum, out_dtype)
    m, k = x2.shape
    n = data.shape[1]
    if (x2.dtype != torch.bfloat16 or data.dtype != torch.uint8
            or scale.dtype != torch.float32 or zp.dtype != torch.int32
            or xsum.dtype != torch.float32):
        raise TypeError("w4_gemv: x bf16, data uint8, scale f32, zp int32, "
                        "xsum f32 expected")
    if data.shape[0] * 2 != k or n % _COLS or k % 256 or m > M_MAX:
        raise ValueError(f"w4_gemv: unsupported shape m={m} k={k} n={n}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"w4_gemv: out dtype {out_dtype} not supported")
    for t in (x2, data, scale, zp, xsum):
        if not t.is_contiguous() or t.device != x2.device:
            raise ValueError("w4_gemv: operands must be contiguous and on "
                             "one device")
    ksplit, rows = split_k(m, k, n, _build.sm_count(x2.device.index))
    out = torch.empty((m, n), dtype=out_dtype, device=x2.device)
    partial = (torch.empty((ksplit, m, n), dtype=torch.float32,
                           device=x2.device) if ksplit > 1 else out)
    err = _build.library().pq_w4_gemv(
        x2.data_ptr(), data.data_ptr(), scale.data_ptr(), zp.data_ptr(),
        xsum.data_ptr(), out.data_ptr(), partial.data_ptr(), m, k, n, ksplit,
        rows, int(out_dtype == torch.bfloat16), _build.stream_ptr(x2))
    _build.check(err, "w4_gemv")
    w4_gemv.launches += 1
    return out


w4_gemv.launches = 0


def quantized_matmul(x: torch.Tensor, ql, out_dtype=torch.bfloat16
                     ) -> Optional[torch.Tensor]:
    """x [..., K] @ packed INT4 weight -> [..., N]; None where the reference
    dispatch has no kernel either (N % 128, K % 256, M > 64).  An INT8
    weight inside that gate reaches `_w8_kernel` in the reference, which
    is not ported yet: None on the CPU (its plain version is the dequant
    path), NotImplementedError on CUDA tensors."""
    k, n = ql.k, ql.n
    if n % 128 or k % 256:
        return None
    lead = x.shape[:-1]
    m = 1
    for d in lead:
        m *= d
    if m > M_MAX:
        return None
    if ql.bits == 8:
        if x.is_cuda:
            raise NotImplementedError("the INT8 GEMV (_w8_kernel) is not "
                                      "ported yet")
        return None
    x2 = x.reshape(m, k).to(torch.bfloat16).contiguous()
    xsum = x2.float().sum(dim=1, keepdim=True)
    scale = ql.scale.float().reshape(-1).expand(n).contiguous()
    zp = ql.zero_point.to(torch.int32).reshape(-1).expand(n).contiguous()
    y = w4_gemv(x2, ql.data, scale, zp, xsum, out_dtype)
    return y.reshape(*lead, n)
