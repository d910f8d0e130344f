"""Tracking: host wall time a frame inside the ``frame.track.candidates``
range of the traced frames (the range's span on the host, torch.profiler).
Nested in ``frame.track``: the candidate build at the propagated pose
(one hash probe and the feature gathers); its device time stays with
``frame.track``."""


def read(trace):
    return trace.stage_host_ms.get("frame.track.candidates")
