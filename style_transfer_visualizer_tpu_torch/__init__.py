"""PyTorch/CUDA port of the style-transfer visualizer.

A second package beside the JAX one (``style_transfer_visualizer_tpu``),
which stays the reference. Module names follow the JAX package so each
counterpart is easy to find. Feature maps keep the JAX layout, NHWC
contiguous, at every public function of the feature path.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on a CUDA tensor every 3x3 conv and every Gram goes
through the hand-written Hopper kernels under ``csrc/``, and on a CPU
tensor through their plain PyTorch versions.
"""
