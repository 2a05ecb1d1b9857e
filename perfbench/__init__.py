"""The benchmark of ``vican_torch`` on one or more CUDA cards.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` (perfbench/README.md).
Nothing here imports JAX or the JAX package; ``perfbench/reference/``
imports nothing of the port either.
"""
