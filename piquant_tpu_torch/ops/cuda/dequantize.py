"""Dequantize: u8 / i8 / u16 / i16 codes or packed uint4 / int4 / uint2 bytes
-> f32 / bf16, SET or ADD (counterpart of
piquant_tpu/ops/pallas/dequantize.py: `_direct_kernel` and
`_mxu_unpack_kernel`).

`dequantize` launches the hand-written kernel (csrc/dequantize.cu) on CUDA
tensors and runs `dequantize_plain` (ops/reference.py) on CPU tensors.  ADD
adds into the accumulator in place, where the TPU kernel aliased it.
"""

from __future__ import annotations

from typing import Optional

import torch

from piquant_tpu_torch.dtypes import QDType, dtype_of, packed_numel
from piquant_tpu_torch.ops import reference as ref
from piquant_tpu_torch.ops.cuda import _build
from piquant_tpu_torch.ops.cuda.quantize import (CODES, FLOATS, affine_args,
                                                 check_flat)


def dequantize_plain(q: torch.Tensor, numel: int, scale, zero_point,
                     dt: QDType, odt: QDType,
                     add_into: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (codes or packed bytes) -> [numel] floats of odt; with `add_into`,
    adds into that tensor in place and returns it."""
    return ref.dequantize(q, numel, scale, zero_point, dt, odt,
                          "set" if add_into is None else "add", add_into)


def dequantize(q: torch.Tensor, numel: int, scale, zero_point, dt, odt,
               add_into: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel wrapper; see `dequantize_plain` for the function."""
    dt, odt = dtype_of(dt), dtype_of(odt)
    if not q.is_cuda:
        return dequantize_plain(q, numel, scale, zero_point, dt, odt, add_into)
    _build.no_grad("dequantize", "13", q, scale, zero_point)
    if (dt.name not in CODES or q.dtype != dt.storage
            or odt.storage not in FLOATS):
        raise TypeError(f"dequantize: {CODES} codes in their storage dtype "
                        f"-> f32/bf16 expected, got {dt.name} as {q.dtype} "
                        f"-> {odt.name}")
    check_flat("dequantize", q, q.device)
    if numel <= 0 or q.numel() != packed_numel(numel, dt):
        raise ValueError(f"dequantize: {q.numel()} storage elements for "
                         f"numel={numel} {dt.name} codes")
    if add_into is None:
        out = torch.empty(numel, dtype=odt.storage, device=q.device)
    else:
        check_flat("dequantize", add_into, q.device)
        if add_into.dtype != odt.storage or add_into.numel() != numel:
            raise ValueError("dequantize: the accumulator must hold numel "
                             "elements of the output dtype")
        out = add_into
    sp, sv, zpp, zpv, keep = affine_args(scale, zero_point, q.device)
    err = _build.library().pq_dequantize(
        q.data_ptr(), out.data_ptr(), numel, dt.bits, int(dt.kind == "int"),
        int(odt.storage == torch.bfloat16), sp, sv, zpp, zpv,
        int(add_into is not None), _build.stream_ptr(q))
    _build.check(err, "dequantize")
    del keep
    dequantize.launches += 1
    return out


dequantize.launches = 0
