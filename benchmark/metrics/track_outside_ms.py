"""Tracking: host wall time a frame of the tracking work outside
``frame.track``: the ``frame.predict`` range (the crop and train masks, the
IMU propagation, the source points and their deskew) and the
``frame.bookkeep`` range (the pose's projection to SO(3), the stop and
lose-track bookkeeping, the pose writes, the full scan's deskew)."""


def read(trace):
    parts = [trace.stage_host_ms.get(n) for n in ("frame.predict", "frame.bookkeep")]
    if all(p is None for p in parts):
        return None
    return sum(p for p in parts if p is not None)
