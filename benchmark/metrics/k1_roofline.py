"""Kernel K1 (the fused mapping Adam loop, ``csrc/map_loop.cu``): the least
time its launches in the traced frames could take, over their device time,
in %. The least time of a launch is the larger of its operations at the
card's f32 peak and its bytes at the memory rate, counted from its shapes
and its step count (``harness/counts.py``); the device time is the
kernel's in the profiler's trace."""


def read(trace):
    if not trace.k1:
        return None
    bound = sum(max(k["flops"] / trace.peak["f32_flops"], k["bytes"] / trace.peak["bytes_s"])
                for k in trace.k1)
    return 100.0 * bound / sum(k["device_s"] for k in trace.k1)
