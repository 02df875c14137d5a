"""Share of the traced window (first span's start to last span's end) in which
no kernel, copy or fill ran on the card."""


def read(trace):
    win = trace.window
    if win is None or not trace.device_ops:
        return None
    length = (win[1] - win[0]) / 1e9
    return 100.0 * (1.0 - trace.busy_seconds() / length) if length > 0 else None
