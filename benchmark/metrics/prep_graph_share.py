"""Map prep: the share of the traced frames whose prep ran as replays of
its CUDA graphs, by the program's counters ``prep.graph_frames`` over
``frames`` (``clid_slam_torch/utils/observability.py``), which count while
torch's profiler records. None unless the counters' ``frames`` are the
traced frames, and where the program counts no prep replays (a program
without the prep graphs)."""


def read(trace):
    try:
        from clid_slam_torch.utils.observability import counters
    except ImportError:  # a program without counters
        return None
    c = counters()
    if not trace.frames or c.get("frames") != trace.frames or "prep.graph_frames" not in c:
        return None
    return c["prep.graph_frames"] / c["frames"]
