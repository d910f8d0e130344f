"""Gathers K2-K7 (``csrc/gather.cu``: ``gather_rows``, ``gather_lanes``):
the summed least times of every launch in the traced frames over their
summed device time, in %. A launch's bytes are its indices read once, its
output written once and the 32-byte table sectors that its indices touch
(``harness/counts.py:gather_bytes``), at the card's memory rate."""


def read(trace):
    if not trace.gathers:
        return None
    bound = sum(g["bytes"] / trace.peak["bytes_s"] for g in trace.gathers)
    return 100.0 * bound / sum(g["device_s"] for g in trace.gathers)
