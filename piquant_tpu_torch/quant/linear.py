"""Weight-only quantized linear layers: the channelwise / per-tensor INT4
and INT8 subset of piquant_tpu/quant/linear.py.

Storage is byte-identical to the reference: a 4-bit weight W[K, N] is the
"split-half" bytes B[K//2, N] with
    B[k, n] = (codes[k, n] & 0xF) | (codes[k + K//2, n] << 4),
so a weight packed by either package can be read by the other, and
    x @ W = x[:, :K/2] @ deq(lo) + x[:, K/2:] @ deq(hi).
The affine zero point folds analytically,
    x @ ((c - zp) * s) = (x @ c) * s - (sum_k x) * (zp * s),
so the products run on the raw codes (exact in bf16) with f32 accumulation.

Grouped, INT2, NF4 and activation-quantized weights are not ported yet and
raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from piquant_tpu_torch.ops.cuda import qmatmul as _qmm
from piquant_tpu_torch.ops.reference import round_half_away


# ---------------------------------------------------------------------------
# split-half packing
# ---------------------------------------------------------------------------

def pack_split_half(codes: torch.Tensor) -> torch.Tensor:
    """Pack int4 codes [K, N] -> bytes [K//2, N] (split-half layout)."""
    k = codes.shape[0]
    if k % 2:
        raise ValueError(f"K={k} must be even for split-half packing")
    lo = codes[: k // 2].to(torch.uint8) & 0xF
    hi = codes[k // 2:].to(torch.uint8) & 0xF
    return lo | (hi << 4)


def unpack_split_half(packed: torch.Tensor) -> torch.Tensor:
    """bytes [K//2, N] -> int32 codes [K, N]."""
    b = packed.to(torch.int32)
    return torch.cat([b & 15, (b >> 4) & 15], dim=0)


# ---------------------------------------------------------------------------
# QuantizedLinear
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QuantizedLinear:
    """Packed weight + affine params for y = x @ W.

    data: uint8 [K//2, N] (int4 split-half) or uint8 [K, N] (int8).
    scale/zero_point: (1, N) channelwise or (1, 1) per tensor, f32 / int32.
    """

    data: torch.Tensor
    scale: torch.Tensor
    zero_point: torch.Tensor
    bits: int           # 4 or 8
    k: int              # logical contraction dim
    group_size: Optional[int] = None   # grouped scales: not ported yet

    @property
    def n(self) -> int:
        return self.data.shape[-1]


def quantize_linear_weight(
    w: torch.Tensor,
    bits: int = 4,
    *,
    channelwise: bool = True,
    group_size: Optional[int] = None,
    stochastic: bool = False,
) -> QuantizedLinear:
    """Quantize a [K, N] float weight for weight-only inference: affine
    (scale, zp) per output channel (axis 0 reduced) or per tensor, with the
    reference's scale/zero-point derivation, op for op."""
    if w.ndim != 2:
        raise ValueError("quantize_linear_weight expects a 2-D weight")
    if group_size is not None or stochastic or bits not in (4, 8):
        raise NotImplementedError(
            "only nearest-rounded channelwise/per-tensor INT4 and INT8 "
            "weights are ported (grouped, INT2, NF4 and stochastic are not)")
    k, _ = w.shape
    qmin, qmax = 0, (1 << bits) - 1
    wf = w.float()
    if channelwise:
        rmin = wf.amin(dim=0, keepdim=True)
        rmax = wf.amax(dim=0, keepdim=True)
    else:
        rmin = wf.amin().reshape(1, 1)
        rmax = wf.amax().reshape(1, 1)
    span = rmax - rmin
    scale = torch.where(span == 0, torch.ones_like(span),
                        span / (qmax - qmin)).float()
    zp = torch.clamp(round_half_away(qmin - rmin / scale), qmin, qmax)
    zp = torch.where(span == 0, torch.full_like(zp, (qmax + qmin) >> 1),
                     zp).to(torch.int32)
    rounded = round_half_away(wf / scale)
    codes = torch.clamp(rounded.to(torch.int32) + zp, qmin, qmax)
    data = pack_split_half(codes) if bits == 4 else codes.to(torch.uint8)
    return QuantizedLinear(data=data, scale=scale, zero_point=zp, bits=bits,
                           k=k)


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------

def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., K] @ b [K, N] with f32 accumulation and f32 output — the
    reference's `jnp.dot(..., preferred_element_type=float32)`.  bf16
    operands multiply exactly in f32 either way; on the GPU the bf16 GEMM
    writes f32 directly instead of upcasting the weight."""
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    if a2.is_cuda and a2.dtype == b.dtype == torch.bfloat16:
        y = torch.mm(a2, b, out_dtype=torch.float32)
    else:
        y = a2.float() @ b.float()
    return y.reshape(*lead, b.shape[-1])


def _matmul_dequant(x: torch.Tensor, ql: QuantizedLinear,
                    out_dtype) -> torch.Tensor:
    """Prefill-sized path (reference `_matmul_dequant_jnp`): raw-code
    products on the two split-half planes, then the zero-point fold."""
    scale = ql.scale.float()
    zp = ql.zero_point.float()
    xb = x.to(torch.bfloat16)
    if ql.bits == 4:
        kh = ql.k // 2
        lo = (ql.data & 15).to(torch.bfloat16)
        hi = (ql.data >> 4).to(torch.bfloat16)
        acc = dot_f32(xb[..., :kh], lo) + dot_f32(xb[..., kh:], hi)
    else:
        acc = dot_f32(xb, ql.data.to(torch.bfloat16))
    xsum = x.float().sum(dim=-1, keepdim=True)
    return (acc * scale - xsum * (zp * scale)).to(out_dtype)


def quantized_matmul(x: torch.Tensor, ql: QuantizedLinear,
                     out_dtype=torch.bfloat16, *,
                     act_quant: bool = False) -> torch.Tensor:
    """y = x @ dequant(W) with the weight kept packed.  Decode-sized INT4
    shapes go to the hand-written GEMV (ops/cuda/qmatmul.py); everything
    else takes the plain dequant path, as in the reference dispatch."""
    if x.shape[-1] != ql.k:
        raise ValueError(f"x last dim {x.shape[-1]} != weight K {ql.k}")
    if act_quant:
        raise NotImplementedError("activation-quantized (W4A8/W8A8) "
                                  "matmuls are not ported yet")
    if ql.group_size is not None:
        raise NotImplementedError("grouped weights are not ported yet")
    y = _qmm.quantized_matmul(x, ql, out_dtype)
    if y is not None:
        return y
    return _matmul_dequant(x, ql, out_dtype)
