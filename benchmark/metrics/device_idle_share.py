"""Device: the share of the traced frames' wall time in which no kernel,
copy or set ran on the card, in % (1 - busy / wall)."""


def read(trace):
    if trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
