"""Driver (``StreamingSlam.process_frame``'s own host work): wall time a
traced frame that lies in no top-level ``frame.*`` range (a name with one
dot): the traced frames' wall over their count, less the host spans of
those ranges. What is left is the host's work between the ranges, the BA's
``ba`` range where it runs, and the benchmark's pose read between frames."""


def read(trace):
    if trace.frames <= 0 or trace.window_s <= 0:
        return None
    spanned = sum(ms for name, ms in trace.stage_host_ms.items()
                  if name.startswith("frame.") and name.count(".") == 1)
    return trace.window_s * 1e3 / trace.frames - spanned
