"""Map prep: device time a frame of the kernels, copies and sets launched
inside the ``frame.prep`` range of the traced frames (torch.profiler's device
trace, each activity placed by the host span of its launch)."""


def read(trace):
    return trace.stage_device_ms.get("frame.prep")
