"""Wrappers of the hand-written Hopper kernels in piquant_tpu_torch/csrc.

Each wrapper launches its kernel on CUDA tensors, runs the kernel's plain
PyTorch version on CPU tensors, and counts its launches in a plain int
attribute (`w4_gemv.launches`, ...)."""
