"""Seconds from the process's start to the window's: imports, kernel build or load,
the fields made on the card, and the warm-up rounds."""


def read(window):
    return window.setup_s
