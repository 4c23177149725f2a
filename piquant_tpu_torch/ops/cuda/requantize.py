"""Requantize: fused quantize -> dequantize (fake-quant) of f32 / bf16 for
every code type of <= 16 bits, SET or ADD (counterpart of
piquant_tpu/ops/pallas/requantize.py::_requant_kernel).

`requantize` launches the hand-written kernel (csrc/requantize.cu) on CUDA
tensors and runs `requantize_plain` (ops/reference.py) on CPU tensors.  ADD
adds into the accumulator in place.
"""

from __future__ import annotations

from typing import Optional

import torch

from piquant_tpu_torch.dtypes import QDType, dtype_of
from piquant_tpu_torch.ops import reference as ref
from piquant_tpu_torch.ops.cuda import _build
from piquant_tpu_torch.ops.cuda.quantize import FLOATS, affine_args, check_flat


def requantize_plain(x: torch.Tensor, scale, zero_point, dt: QDType,
                     stochastic: bool = False, seed: int = 0,
                     add_into: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [n] -> [n] of x's dtype; with `add_into`, adds into that tensor in
    place and returns it."""
    return ref.requantize(x, scale, zero_point, dt,
                          "stochastic" if stochastic else "nearest",
                          "set" if add_into is None else "add", add_into,
                          seed=seed)


def requantize(x: torch.Tensor, scale, zero_point, dt,
               stochastic: bool = False, seed: int = 0,
               add_into: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel wrapper; see `requantize_plain` for the function."""
    dt = dtype_of(dt)
    if not x.is_cuda:
        return requantize_plain(x, scale, zero_point, dt, stochastic, seed,
                                add_into)
    _build.no_grad("requantize", "13", x, scale, zero_point)
    if x.dtype not in FLOATS or not dt.is_quant or dt.bits > 16:
        raise TypeError(f"requantize: f32/bf16 with a <= 16-bit code type "
                        f"expected, got {x.dtype} with {dt.name}")
    check_flat("requantize", x, x.device)
    n = x.numel()
    if n == 0:
        raise ValueError("requantize: empty input")
    if add_into is None:
        out = torch.empty_like(x)
    else:
        check_flat("requantize", add_into, x.device)
        if add_into.dtype != x.dtype or add_into.numel() != n:
            raise ValueError("requantize: the accumulator must match x in "
                             "dtype and size")
        out = add_into
    sp, sv, zpp, zpv, keep = affine_args(scale, zero_point, x.device)
    err = _build.library().pq_requantize(
        x.data_ptr(), out.data_ptr(), n, int(x.dtype == torch.bfloat16),
        dt.bits, int(dt.kind == "int"), sp, sv, zpp, zpv, int(stochastic),
        int(seed) & ((1 << 64) - 1), int(add_into is not None),
        _build.stream_ptr(x))
    _build.check(err, "requantize")
    del keep
    requantize.launches += 1
    return out


requantize.launches = 0
