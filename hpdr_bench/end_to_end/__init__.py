"""End-to-end metric readers, one module a metric, named as in ``BENCHMARK.json``.

Each module has ``read(window) -> float | None``: ``window`` is a
``harness.Window``, the timed calls and phases of a run with tracing off.
"""
