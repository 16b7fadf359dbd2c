"""The benchmark's fixed arithmetic: peaks, step FLOPs, the launches a
traced image makes and what each needs at the least.

Frozen here so that a change to the port cannot move the yardstick;
``port_bench/tests`` holds the copies equal to the port's own counts
at the cells' shapes.
"""
