"""Tracking: IESEKF iterations a traced frame, by the program's counter
``track.iters`` (``clid_slam_torch/utils/observability.py``), which
counts while torch's profiler records. None unless the counter's
``frames`` are the traced frames."""


def read(trace):
    try:
        from clid_slam_torch.utils.observability import counters
    except ImportError:  # a program without counters
        return None
    c = counters()
    if c.get("frames") != trace.frames or "track.iters" not in c:  # not the traced frames, or none counted
        return None
    return c["track.iters"] / trace.frames
