"""Device: the host's waits on the card a traced frame inside
``process_frame``, by the program's counter ``syncs``: the synchronising
CUDA operations that ``torch.cuda.set_sync_debug_mode("warn")`` reports
(error-checked linalg, blocking copies either way, ``.item()``, ``bool()``,
``int()``). None unless the counter's ``frames`` are the traced frames;
absent off the card."""


def read(trace):
    try:
        from clid_slam_torch.utils.observability import counters
    except ImportError:  # a program without counters
        return None
    c = counters()
    if c.get("frames") != trace.frames or "syncs" not in c:  # not the traced frames, or none counted
        return None
    return c["syncs"] / trace.frames
