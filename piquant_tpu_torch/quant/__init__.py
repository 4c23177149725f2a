"""Quantized linear weights and the quantized KV cache."""
