"""Program drivers: how a configuration calls the program (one module each)."""
