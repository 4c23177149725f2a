"""Reference helpers, dispatchers and the CUDA kernels' wrappers."""
