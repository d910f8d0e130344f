"""Device: ``frame_mfu`` with the operations of the tracker's graph
replays added back, in %. A replay of the captured IESEKF iteration
(``clid_slam_torch/odometry/iekf.py:_GraphedIterations``) dispatches no
torch operation, so the profiler's ``with_flops`` count, and with it
``frame_mfu``, misses the decoder's products and the rest of each
replayed iteration. The program counts them in ``track.graph_flops``:
each replay times its iteration's operations, counted once on an eager
warm-up with the profiler's formulas (``iekf.py:flops_of``; beside them
the autograd engine's sums of gradients, a few % of an iteration, which
the profiler does not record). None where the program counts no replays
or the counters are not the traced frames'."""

import importlib.util
import os


def _frame_mfu():
    """``read`` of ``frame_mfu.py`` beside this file."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "frame_mfu.py")
    spec = importlib.util.spec_from_file_location("frame_mfu_of_replays", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read(trace):
    try:
        from clid_slam_torch.utils.observability import counters
    except ImportError:  # a program without counters
        return None
    c = counters()
    if c.get("frames") != trace.frames or "track.graph_flops" not in c:
        return None
    share = _frame_mfu()(trace)
    if share is None:
        return None
    return share + 100.0 * c["track.graph_flops"] / (trace.window_s * trace.peak["f32_flops"])
