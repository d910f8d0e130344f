"""Tracking: host wall time an IESEKF iteration, the traced frames'
``frame.track.iter`` ranges (nested in ``frame.track``, the exit flag's
read included) over their iterations by the program's counter
``track.iters``. None unless the counter's ``frames`` are the traced
frames."""


def read(trace):
    try:
        from clid_slam_torch.utils.observability import counters
    except ImportError:  # a program without counters
        return None
    c = counters()
    ms = trace.stage_host_ms.get("frame.track.iter")
    if c.get("frames") != trace.frames or not c.get("track.iters") or ms is None:
        return None
    return ms * trace.frames / c["track.iters"]
