"""Tracking: the share of the traced frames' IESEKF iterations that ran as
a replay of the captured CUDA graph, by the program's counters
``track.graph_iters`` over ``track.iters``
(``clid_slam_torch/utils/observability.py``), which count while torch's
profiler records. None unless the counters' ``frames`` are the traced
frames, and where the program counts no graph replays (a program without
the graph)."""


def read(trace):
    try:
        from clid_slam_torch.utils.observability import counters
    except ImportError:  # a program without counters
        return None
    c = counters()
    if c.get("frames") != trace.frames or not c.get("track.iters") or "track.graph_iters" not in c:
        return None
    return c["track.graph_iters"] / c["track.iters"]
