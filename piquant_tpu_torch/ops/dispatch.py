"""Routing of the library-core ops (counterpart of
piquant_tpu/ops/dispatch.py).

A combination goes to the kernel wrapper exactly where the JAX package's
Pallas front door takes it (the `return None` conditions of
ops/pallas/{quantize,dequantize,requantize,minmax}.py):
  * quantize: f32/bf16 -> u8/i8/u16/i16/uint4/int4/uint2, nearest or
    stochastic;
  * dequantize: those codes -> f32/bf16, SET or ADD;
  * requantize: f32/bf16 with any code type of <= 16 bits;
  * min/max (compute_quant_params): f32/bf16;
each for a non-empty input with a scalar scale and zero point.  On a CUDA
tensor the wrapper launches its kernel; on a CPU tensor it runs the plain
version.  Every other combination (f64, 32/64-bit codes, per-element
scales) runs the plain reference on the tensor's own device, as the JAX
package runs jnp there.
"""

from __future__ import annotations

from typing import Optional

import torch

from piquant_tpu_torch.dtypes import QDType
from piquant_tpu_torch.ops import reference as ref
from piquant_tpu_torch.ops.cuda import dequantize as DQ
from piquant_tpu_torch.ops.cuda import minmax as MM
from piquant_tpu_torch.ops.cuda import quantize as QK
from piquant_tpu_torch.ops.cuda import requantize as RQ


def _scalar(v) -> bool:
    return not isinstance(v, torch.Tensor) or v.numel() == 1


def _kernel_float(x: torch.Tensor) -> bool:
    return x.dtype in QK.FLOATS and x.numel() > 0


def _flat_into(out: torch.Tensor, run) -> torch.Tensor:
    """run(flat accumulator) adds into `out` in place, through a contiguous
    copy when `out` is not contiguous."""
    if out.is_contiguous():
        run(out.view(-1))
    else:
        acc = out.contiguous()
        run(acc.view(-1))
        out.copy_(acc)
    return out


def quantize(x: torch.Tensor, scale, zero_point, dt: QDType, round_mode: str,
             *, seed: Optional[int] = None) -> torch.Tensor:
    if (_kernel_float(x) and dt.name in QK.CODES and _scalar(scale)
            and _scalar(zero_point)):
        return QK.quantize(x, scale, zero_point, dt,
                           round_mode == "stochastic", seed or 0)
    return ref.quantize(x, scale, zero_point, dt, round_mode, seed=seed)


def dequantize(q: torch.Tensor, numel: int, scale, zero_point, dt: QDType,
               odt: QDType, reduce_op: str,
               out: Optional[torch.Tensor]) -> torch.Tensor:
    if (dt.name in QK.CODES and q.dtype == dt.storage
            and odt.storage in QK.FLOATS and numel > 0 and _scalar(scale)
            and _scalar(zero_point)):
        if reduce_op == "add":
            return _flat_into(out, lambda acc: DQ.dequantize(
                q, numel, scale, zero_point, dt, odt, add_into=acc))
        return DQ.dequantize(q, numel, scale, zero_point, dt, odt)
    return ref.dequantize(q, numel, scale, zero_point, dt, odt, reduce_op, out)


def requantize(x: torch.Tensor, scale, zero_point, dt: QDType,
               round_mode: str, reduce_op: str, out: Optional[torch.Tensor],
               *, seed: Optional[int] = None) -> torch.Tensor:
    if (_kernel_float(x) and dt.is_quant and dt.bits <= 16 and _scalar(scale)
            and _scalar(zero_point)):
        stochastic = round_mode == "stochastic"
        if reduce_op == "add":
            return _flat_into(out, lambda acc: RQ.requantize(
                x, scale, zero_point, dt, stochastic, seed or 0, add_into=acc))
        return RQ.requantize(x, scale, zero_point, dt, stochastic, seed or 0)
    return ref.requantize(x, scale, zero_point, dt, round_mode, reduce_op, out,
                          seed=seed)


def compute_quant_params(x: torch.Tensor, dt: QDType):
    if _kernel_float(x):
        mm = MM.min_max(x)
        return ref.params_from_min_max(mm[0], mm[1], dt)
    return ref.compute_quant_params(x, dt)
