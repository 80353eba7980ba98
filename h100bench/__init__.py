"""The benchmark of ``tpu_inference_torch`` on one NVIDIA H100.

``python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout serves one cell of
``BENCHMARK.json`` through the port's HTTP server and prints one JSON
result line. Everything that belongs to one configuration, traffic mix,
cell or per-layer metric is a file of its own, found by its name:
``configs/``, ``traffic/``, ``cells/`` and ``metrics/``. The plain
reference that decides ``correct`` is ``reference/``; it imports nothing
of the port.
"""
