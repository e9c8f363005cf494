"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. Every
configuration (``configs/``), traffic mix (``traffic/``), loop (``loops/``)
and metric (``metrics/``) is a file that the harness finds by its name.
Nothing here imports ``jax``, ``jaxlib`` or the JAX package ``repro``.
"""
