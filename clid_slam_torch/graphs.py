"""CUDA graphs of the frame step's stages: how a stage is captured, replayed
and counted on the card, in one place.

Three families replay captured stages: the cached tracker's IESEKF
iteration (``odometry/iekf.py:_GraphedIterations``), a tracked frame's
predict and bookkeep (``pipeline/streaming.py:GraphedTrackStages``) and its
map prep (``mapping/prep.py:GraphedPrep``). Each keeps what is its own:
which buffers exist, when the state is copied in, the per-frame fills and
its counters. A replay repeats the captured kernels on the captured
addresses, so every value that changes from frame to frame enters through a
buffer filled before the replay; a value the capture computed on the host
is a constant of every replay.

What they share is here:

- ``buffers``, ``layout_key`` and ``fill``: a capture's fixed inputs,
  copies of its first inputs strided as they are, what a capture holds
  fixed of them, and the copies into them before a replay;
- ``Capture``: a memory pool and a stream, into which stages are captured
  after a warm-up, with cuBLAS's workspaces cleared around each phase;
- ``replay`` of a captured stage;
- ``flops_of`` and ``op_count``: what a replay computes, which no profiler
  sees (a replay dispatches no operation).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional

import torch

from .ops import gather as gt


def buffers(tensors) -> list:
    """Copies of ``tensors`` into tensors of their own, each with its
    shape, strides and dtype: a strided view (a slice of the frame's
    upload, of the sharded tracker's exchanged payload) gets a buffer
    strided as it is, so the replays run the eager kernels on the eager
    layouts."""
    return [torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                device=x.device).copy_(x.detach()) for x in tensors]


def layout_key(tensors) -> tuple:
    """What a capture holds fixed of its inputs: each one's shape, strides,
    dtype and device."""
    return tuple((x.shape, x.stride(), x.dtype, x.device) for x in tensors)


def fill(bufs, tensors) -> None:
    """Copy each of ``tensors`` into its buffer, unless it is that buffer (a
    state that came out of the last replay holds the buffers)."""
    for buf, x in zip(bufs, tensors):
        if x is not buf:
            buf.copy_(x)


def _clear_cublas_workspaces() -> None:
    # cuBLAS keeps a workspace (~35 MB) per stream. Cleared before each phase
    # and after the captures, one at a time is allocated (a capture's stays in
    # its graph's pool), so a capture's allocated peak is an eager run's
    # (torch._inductor's graphs do the same). The call is private to torch
    # (there in torch 2.11 and 2.13) and may go in another version: then the
    # capture fails here, before any frame.
    torch._C._cuda_clearCublasWorkspaces()


class Capture:
    """A memory pool and a stream of their own, into which a call captures
    stages. One object serves one family's key (the tracker's iteration;
    predict and bookkeep, which share it) or one family's object (prep,
    whose two variants share it): a pool's blocks serve the stream they
    were captured on."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream()
        self.steps = []  # the stage under capture: its graphs and breaks so far

    def __call__(self, stages, warm_up: Optional[Callable[[], object]] = None,
                 breaks: bool = False) -> list:
        """Each of ``stages`` (functions of no argument) captured, in order,
        after a warm-up; returns each stage's steps for ``replay``: CUDA
        graphs and, between them, the breaks.

        The warm-up runs the stages once before any capture, as
        ``torch.cuda.graphs`` asks, so that first-use work (cuBLAS's
        handles, the autograd engine's) stays out of the graphs:
        - by default on this object's stream, off the frames' stream. What
          it leaves in the allocator's cache belongs to that stream, where
          no frame reuses it, so it goes back to the card before each
          capture, as ``torch.cuda.graph`` does it;
        - a caller's own ``warm_up`` runs on the frames' stream, so that its
          scratch stays cached where the frames reuse it, and nothing is
          freed. Prep's gathers with the plain version there, so that a
          frame that captures launches the kernels of one that replays.

        With ``breaks``, each row gather on the card
        (``ops/gather.py:gather_rows``, a hand kernel) ends a graph: at each
        replay it runs eagerly between two graphs, where the benchmark's
        launch recorder sees it, and its rows are copied to where the next
        graph reads them. Without, a stage captures the hand kernels it
        launches with the rest, and a stage is one graph."""
        frames = torch.cuda.current_stream()
        _clear_cublas_workspaces()
        if warm_up is None:
            self.stream.wait_stream(frames)
            with torch.cuda.stream(self.stream):
                for stage in stages:
                    stage()
            frames.wait_stream(self.stream)
        else:
            warm_up()
        torch.cuda.synchronize()
        _clear_cublas_workspaces()
        self.stream.wait_stream(frames)
        captured = []
        with (torch.cuda.stream(self.stream),
              gt.breaks(self._break) if breaks else contextlib.nullcontext()):
            for stage in stages:
                if warm_up is None:
                    torch.cuda.empty_cache()
                self._begin()
                stage()
                self.steps[-1].capture_end()
                captured.append(self.steps)
                self.steps = []
        frames.wait_stream(self.stream)
        _clear_cublas_workspaces()
        return captured

    def _begin(self):
        self.steps.append(torch.cuda.CUDAGraph())
        # thread-local: another thread's CUDA call during the capture (NCCL's
        # watchdog querying its events, in the sharded driver) neither fails
        # nor invalidates it; this thread's still fail
        self.steps[-1].capture_begin(pool=self.pool, capture_error_mode="thread_local")

    def _break(self, table, idx):
        """``ops/gather.py:breaks``' hook: a row gather ends the graph under
        capture and leaves ``(table, idx, out)`` before the next."""
        self.steps[-1].capture_end()
        # only its place matters: the replays fill it
        out = table.new_empty((idx.shape[0], table.shape[1]))
        self.steps.append((table, idx, out))
        self._begin()
        return out


def replay(steps) -> None:
    """One replay of a captured stage: its graphs in order and, between
    them, each row gather run eagerly into the buffer the next graph
    reads."""
    for step in steps:
        if isinstance(step, torch.cuda.CUDAGraph):
            step.replay()
        else:
            table, idx, out = step
            out.copy_(gt.gather_rows(table, idx))


def flops_of(fn: Callable[[], object]) -> dict:
    """Run ``fn()`` once and return its operations by op, ``{"aten::mm":
    n, ...}``, by the formulas of torch's profiler (``with_flops``, the
    count ``frame_mfu`` reads): 2·m·n·k a matrix product, and for each
    ``mul`` and ``add`` one an element of its first operand. Counted on the
    dispatched ops, it also counts the autograd engine's sums of gradients,
    which the profiler does not record (a few % of an IESEKF iteration).
    No profiler is started (one takes seconds to start on the card, and
    profilers do not nest), but a first dispatch mode imports
    ``torch._dynamo`` (about 2 s). A profiler that runs already records the
    counted ops twice (as dispatched, and as the counting mode runs them)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    def numel(x):
        return x.numel() if isinstance(x, torch.Tensor) else 0

    def product(a, b):  # [.., m, k] @ [.., k, n]
        return 2 * numel(a) * b.shape[-1]

    aten = torch.ops.aten
    rules = {aten.mm: lambda a, b, *_, **__: product(a, b),
             aten.bmm: lambda a, b, *_, **__: product(a, b),
             aten.addmm: lambda c, a, b, *_, **__: product(a, b),
             aten.baddbmm: lambda c, a, b, *_, **__: product(a, b),
             aten.mul: lambda a, *_, **__: numel(a),
             aten.add: lambda a, *_, **__: numel(a)}
    counts = {}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            rule = rules.get(func.overloadpacket)
            if rule is not None:
                name = f"aten::{func.overloadpacket.__name__}"
                counts[name] = counts.get(name, 0) + rule(*args, **(kwargs or {}))
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return counts


def op_count(fn: Callable[[], object], device) -> Callable[[], int]:
    """The operations of a replay, as a function for ``observability.count``:
    ``fn()``, an eager run of the captured work that leaves the buffers as
    they are, counted (``flops_of``, summed) on ``device`` at the first call
    and remembered. The counters call it when they are read, after the
    traced frames, so the count disturbs none of them."""

    @functools.cache
    def count() -> int:
        with torch.cuda.device(device):
            return sum(flops_of(fn).values())

    return count
