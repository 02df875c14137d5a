"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` is the entry point; ``BENCHMARK.json`` at the root of the
repository lists the cells, and every configuration, traffic mix, program
driver, check and per-layer metric sits in a file of its own here that the
harness finds by the name the cell or the metric gives.
"""
