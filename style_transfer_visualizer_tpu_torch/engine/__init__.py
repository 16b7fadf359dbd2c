"""Optimizer, update step, and the step loop of the port."""
