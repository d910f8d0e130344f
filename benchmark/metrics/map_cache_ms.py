"""Mapping: host wall time a frame inside the ``frame.map.cache``
range of the traced frames (the range's span on the host, torch.profiler).
Nested in ``frame.map``: the batch cache and the gathers before the
fused kernel or the autograd loop; its device time stays with
``frame.map``."""


def read(trace):
    return trace.stage_host_ms.get("frame.map.cache")
