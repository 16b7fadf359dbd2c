"""Build and load the port's CUDA kernels (``csrc/*.cu``)."""
