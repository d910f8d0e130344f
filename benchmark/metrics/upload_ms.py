"""Driver (``StreamingSlam.process_frame``'s own host work): host wall time
a frame inside the ``frame.upload`` range of the traced frames (the range's
span on the host, torch.profiler): the packed buffer's copy to the card and
its views."""


def read(trace):
    return trace.stage_host_ms.get("frame.upload")
