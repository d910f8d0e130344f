"""Tracking: the share of the traced frames whose predict and bookkeep ran
as replays of their CUDA graphs, by the program's counters
``predict.graph_frames`` over ``frames``
(``clid_slam_torch/utils/observability.py``), which count while torch's
profiler records. None unless the counters' ``frames`` are the traced
frames, and where the program counts no such replays (a program without
the predict and bookkeep graphs)."""


def read(trace):
    try:
        from clid_slam_torch.utils.observability import counters
    except ImportError:  # a program without counters
        return None
    c = counters()
    if not trace.frames or c.get("frames") != trace.frames or "predict.graph_frames" not in c:
        return None
    return c["predict.graph_frames"] / c["frames"]
