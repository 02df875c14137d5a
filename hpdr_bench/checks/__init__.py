"""Output checks: a configuration's comparison with the plain reference (one module each)."""
