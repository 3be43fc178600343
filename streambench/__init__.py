"""The benchmark of the PyTorch and CUDA port (``selkies_tpu_torch``).

``python3 streambench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Configurations, traffic mixes, per-layer metric readers and
plain references are files found by name (``configs/``, ``traffic/``,
``metrics/``, ``reference/``).
"""
