"""The plain reference the benchmark holds the port to.

Plain PyTorch in fp32 with TF32 off, written from the published
description (VGG, arXiv:1409.1556; Gatys et al., arXiv:1508.06576) and
the configuration files under ``port_bench/configs``. It imports no
kernel, no module of the port and nothing of the JAX package, and it
takes nothing the port made: the weights, images and starting point
are made again here from the run's seeds.
"""
