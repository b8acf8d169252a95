"""The benchmark of ``fora_tpu_torch``: one cell of ``BENCHMARK.json`` per
run of ``pprbench/run.py``.  Configurations, traffic mixes, per-layer
metrics and correctness limits are files found by name (``configs/``,
``traffic/``, ``metrics/``, ``cells/``)."""
