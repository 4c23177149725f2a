"""piquant_tpu_torch: the PyTorch / CUDA port of piquant-tpu for NVIDIA
Hopper GPUs.

It sits beside the JAX package (piquant_tpu, the reference it is held
against) and imports nothing of it.  Ported so far:
  * the library core: `quantize`, `dequantize` (SET / in-place ADD),
    `requantize`, `compute_quant_params`, `QuantizedTensor`, over the dtype
    registry of `dtypes`, down to four hand-written CUDA kernels (quantize,
    dequantize, requantize, min/max) under `ops/cuda`.  These run where
    their input tensor lies: on a CUDA tensor the kernels, on a CPU tensor
    their plain PyTorch versions;
  * the INT4 serving path, from `serving.Engine` down to three hand-written
    CUDA kernels (INT4 GEMV, kv8 flash-decode, GQA flash-prefill).  Its
    entry points run on the GPU unless a `device` is given.

    import piquant_tpu_torch as pq
    scale, zp = pq.compute_quant_params(x, "uint8")
    q = pq.quantize(x, scale, zp, "uint8")
"""

from piquant_tpu_torch.dtypes import (  # noqa: F401
    DTYPES,
    FLOAT_DTYPES,
    QUANT_DTYPES,
    QDType,
    dtype_of,
    packed_numel,
    tail_mask,
)
from piquant_tpu_torch.api import (  # noqa: F401
    Context,
    QuantizedTensor,
    ReduceOp,
    RoundMode,
    compute_quant_params,
    dequantize,
    dequantize_tensor,
    quantize,
    quantize_dequantize_fused,
    quantize_tensor,
    requantize,
)

__version__ = "0.2.0"
