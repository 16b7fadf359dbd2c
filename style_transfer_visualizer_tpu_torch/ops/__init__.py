"""Operators of the port: the two kernels' wrappers, ReLU and pooling."""
