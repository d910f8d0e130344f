"""Map prep: host wall time a frame inside the ``frame.prep.local_map``
range of the traced frames (the range's span on the host, torch.profiler).
Nested in ``frame.prep``: the local label map's update; its device time
stays with ``frame.prep``."""


def read(trace):
    return trace.stage_host_ms.get("frame.prep.local_map")
