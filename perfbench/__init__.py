"""The benchmark of ``spfft_tpu_torch`` on an NVIDIA H100.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once. Configurations (``configs/``),
traffic mixes (``traffic/``) and metrics (``metrics/``) are files found by
name; the yardstick (the generator, the reference, the comparison, the
trace's reduction) lives here and imports nothing of the JAX package. A
configuration with ``ranks`` runs over a process group, one process a card
(``ranks.py``, ``shards.py``).
"""
