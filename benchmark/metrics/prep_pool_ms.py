"""Map prep: host wall time a frame inside the ``frame.prep.pool``
range of the traced frames (the range's span on the host, torch.profiler).
Nested in ``frame.prep``: the replay pool's window filter, the novelty
gate and the append; its device time stays with ``frame.prep``."""


def read(trace):
    return trace.stage_host_ms.get("frame.prep.pool")
