"""The benchmark of ``style_transfer_visualizer_tpu_torch`` on the H100.

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once. Nothing here
imports JAX or the JAX package; ``reference/`` imports nothing of the
port either.
"""
