"""Per-layer metric readers, one module a metric, named as in ``BENCHMARK.json``.

Each module has ``read(trace) -> float | None``: ``trace`` is a
``tracing.TraceData``; ``None`` means the run gave the reader nothing to read,
and the harness leaves the metric out of the result line.
"""
