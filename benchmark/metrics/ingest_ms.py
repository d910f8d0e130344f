"""Driver (``StreamingSlam.process_frame``'s own host work): host wall time
a frame inside the ``frame.ingest`` range of the traced frames (the range's
span on the host, torch.profiler). It covers the scan's read from its
arrays, the adaptive crop range, the seeded subsample to
``max_scan_points``, the IMU check and the pack."""


def read(trace):
    return trace.stage_host_ms.get("frame.ingest")
