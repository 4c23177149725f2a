"""Checkpoint and weight-file utilities of the port: the safetensors
container and the reference's quantized export (`safetensors_io`), and the
packed-weight disk cache (`weight_cache`)."""
