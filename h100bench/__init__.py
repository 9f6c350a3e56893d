"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA H100.

``python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``.  Configurations, traffic mixes and
per-layer metrics are files of their own under ``configs/``, ``traffic/``
and ``metrics/``, found by the names that ``BENCHMARK.json`` gives them.
Nothing here imports ``jax``, ``jaxlib`` or the JAX package ``repro``;
``reference/`` imports nothing of ``repro_torch`` either.
"""
