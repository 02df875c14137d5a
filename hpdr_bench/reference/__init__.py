"""Plain PyTorch and numpy statements of the formats the benchmark judges.

Nothing here imports the program (``repro_torch``), its JAX original or JAX.
"""
