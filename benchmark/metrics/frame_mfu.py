"""The whole frame step's share of the card's f32 peak, in %: the
operations of K1's launches (``harness/counts.py:k1_flops``, at each
launch's shapes and step count) and of the torch matmuls (the profiler's
``with_flops`` count: the decoder's products in tracking, the filter and
prep) in the traced frames, over their wall time at 67 TFLOP/s. It bounds
what the kernels' rooflines can claim once a kernel leaves the path."""


def read(trace):
    flops = sum(k["flops"] for k in trace.k1) + trace.matmul_flops
    if flops <= 0 or trace.window_s <= 0:
        return None
    return 100.0 * flops / (trace.window_s * trace.peak["f32_flops"])
