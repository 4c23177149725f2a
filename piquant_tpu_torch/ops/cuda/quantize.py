"""Quantize: f32 / bf16 -> u8 / i8 / u16 / i16 codes or packed uint4 / int4 /
uint2 bytes (counterpart of piquant_tpu/ops/pallas/quantize.py:
`_direct_kernel` and `_mxu_pack_kernel`).

`quantize` launches the hand-written kernel (csrc/quantize.cu) on CUDA
tensors and runs `quantize_plain`, the same function in plain PyTorch
(ops/reference.py), on CPU tensors.
"""

from __future__ import annotations

import torch

from piquant_tpu_torch.dtypes import QDType, dtype_of, packed_numel
from piquant_tpu_torch.ops import reference as ref
from piquant_tpu_torch.ops.cuda import _build

FLOATS = (torch.float32, torch.bfloat16)
CODES = ("uint8", "int8", "uint16", "int16", "uint4", "int4", "uint2")


def affine_args(scale, zero_point, device: torch.device):
    """(scale_ptr, scale_val, zp_ptr, zp_val, keep) for a kernel launch.  A
    scalar tensor on the card is passed by pointer, so the kernel reads it
    there and the host never waits for it; anything else is passed by value
    (f32 scale; int32 zero point, wrapped as the reference's int32 cast
    does).  `keep` holds the converted tensors until the launch is queued."""
    keep, args = [], []
    for v, dtype, host in ((scale, torch.float32, float),
                           (zero_point, torch.int32, ref.wrap_i32)):
        if isinstance(v, torch.Tensor) and v.is_cuda:
            if v.numel() != 1 or v.device != device:
                raise ValueError("scale and zero point must be scalars on the "
                                 "kernel's device")
            keep.append(v.reshape(()).to(dtype))
            args += [keep[-1].data_ptr(), 0]
        else:
            args += [None, host(v)]
    return (*args, keep)


def check_flat(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.dim() != 1 or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name}: operands must be flat, contiguous and on "
                         f"one device")


def quantize_plain(x: torch.Tensor, scale, zero_point, dt: QDType,
                   stochastic: bool = False, seed: int = 0) -> torch.Tensor:
    """x [n] -> codes [n] in dt's storage dtype, or [packed_numel(n)] packed
    bytes for the sub-byte types (ops/reference.py::quantize)."""
    return ref.quantize(x, scale, zero_point, dt,
                        "stochastic" if stochastic else "nearest", seed=seed)


def quantize(x: torch.Tensor, scale, zero_point, dt, stochastic: bool = False,
             seed: int = 0) -> torch.Tensor:
    """Kernel wrapper; see `quantize_plain` for the function."""
    dt = dtype_of(dt)
    if not x.is_cuda:
        return quantize_plain(x, scale, zero_point, dt, stochastic, seed)
    _build.no_grad("quantize", "13", x, scale, zero_point)
    if x.dtype not in FLOATS or dt.name not in CODES:
        raise TypeError(f"quantize: f32/bf16 -> {CODES} expected, got "
                        f"{x.dtype} -> {dt.name}")
    check_flat("quantize", x, x.device)
    n = x.numel()
    if n == 0:
        raise ValueError("quantize: empty input")
    out = torch.empty(packed_numel(n, dt), dtype=dt.storage, device=x.device)
    sp, sv, zpp, zpv, keep = affine_args(scale, zero_point, x.device)
    err = _build.library().pq_quantize(
        x.data_ptr(), out.data_ptr(), n, int(x.dtype == torch.bfloat16),
        dt.bits, int(dt.kind == "int"), sp, sv, zpp, zpv, int(stochastic),
        int(seed) & ((1 << 64) - 1), _build.stream_ptr(x))
    _build.check(err, "quantize")
    del keep
    quantize.launches += 1
    return out


quantize.launches = 0
