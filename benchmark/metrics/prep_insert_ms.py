"""Map prep: host wall time a frame inside the ``frame.prep.insert``
range of the traced frames (the range's span on the host, torch.profiler).
Nested in ``frame.prep``: the neural points' insert; its device time
stays with ``frame.prep``."""


def read(trace):
    return trace.stage_host_ms.get("frame.prep.insert")
