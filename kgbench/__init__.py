"""kgbench: the benchmark of dglke_tpu_torch on an NVIDIA GPU.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) and prints one JSON line; see ``kgbench/README.md``.
"""
