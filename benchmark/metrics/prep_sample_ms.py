"""Map prep: host wall time a frame inside the ``frame.prep.sample``
range of the traced frames (the range's span on the host, torch.profiler).
Nested in ``frame.prep``: the ray sampler and the transform of its
samples; its device time stays with ``frame.prep``."""


def read(trace):
    return trace.stage_host_ms.get("frame.prep.sample")
