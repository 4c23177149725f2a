"""Global (min, max) of f32 / bf16 in one read (counterpart of
piquant_tpu/ops/pallas/minmax.py: `_minmax_kernel`, `min_max`).

`min_max` launches the hand-written kernel (csrc/minmax.cu) on CUDA tensors
and runs `min_max_plain` (ops/reference.py) on CPU tensors.  The (scale,
zero point) finish of `compute_quant_params` is plain torch on the
two-element result (ops/reference.py::params_from_min_max).
"""

from __future__ import annotations

import torch

from piquant_tpu_torch.ops import reference as ref
from piquant_tpu_torch.ops.cuda import _build
from piquant_tpu_torch.ops.cuda.quantize import FLOATS, check_flat

_THREADS = 256      # csrc/minmax.cu: threads per block
_ELEMS = 8          # elements per thread and step
_BLOCKS_PER_SM = 4


def min_max_plain(x: torch.Tensor) -> torch.Tensor:
    """x [n] -> [min, max] in f32; NaN anywhere gives NaN for both."""
    return ref.min_max(x)


def min_max(x: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper; see `min_max_plain` for the function."""
    if not x.is_cuda:
        return min_max_plain(x)
    if x.dtype not in FLOATS:
        raise TypeError(f"min_max: f32/bf16 expected, got {x.dtype}")
    check_flat("min_max", x, x.device)
    n = x.numel()
    if n == 0:
        raise ValueError("min_max: empty input")
    chunks = -(-n // _ELEMS)
    blocks = max(1, min(_BLOCKS_PER_SM * _build.sm_count(x.device.index),
                        -(-chunks // _THREADS)))
    part = torch.empty(2 * blocks, dtype=torch.float32, device=x.device)
    out = torch.empty(2, dtype=torch.float32, device=x.device)
    err = _build.library().pq_minmax(
        x.data_ptr(), part.data_ptr(), out.data_ptr(), n,
        int(x.dtype == torch.bfloat16), blocks, _build.stream_ptr(x))
    _build.check(err, "min_max")
    min_max.launches += 1
    return out


min_max.launches = 0
