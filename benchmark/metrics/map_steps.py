"""Mapping: mapping steps a traced frame, by the program's counter
``map.steps`` (the fused kernel's steps clamped at its ``max_iters``, as it
clamps them; the autograd loop's steps), which counts while torch's
profiler records. None unless the counter's ``frames`` are the traced
frames."""


def read(trace):
    try:
        from clid_slam_torch.utils.observability import counters
    except ImportError:  # a program without counters
        return None
    c = counters()
    if c.get("frames") != trace.frames or "map.steps" not in c:  # not the traced frames, or none counted
        return None
    return c["map.steps"] / trace.frames
