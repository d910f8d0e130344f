"""Tracking: host wall time a frame inside the ``frame.track`` range of the traced
frames (the range's span on the host, torch.profiler)."""


def read(trace):
    return trace.stage_host_ms.get("frame.track")
