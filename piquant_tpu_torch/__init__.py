"""piquant_tpu_torch: the PyTorch / CUDA port of piquant-tpu for NVIDIA
Hopper GPUs.

It sits beside the JAX package (piquant_tpu, the reference it is held
against) and imports nothing of it.  Ported so far: the INT4 serving path,
from `serving.Engine` down to three hand-written CUDA kernels (INT4 GEMV,
kv8 flash-decode, GQA flash-prefill) under `ops/cuda`.  Entry points run on
the GPU unless a `device` is given.
"""

__version__ = "0.1.0"
