"""Flash-attention prefill (counterpart of piquant_tpu/ops/flash_prefill.py).

The reference sends plain causal masks to the TPU kernel shipped with JAX
and every other mask to its own GQA kernel.  Here both are the one
hand-written GQA kernel, so this name is `ops.cuda.flash.flash_prefill_masked`.
"""

from piquant_tpu_torch.ops.cuda.flash import flash_prefill_masked as flash_prefill  # noqa: F401
