"""Observability: profiler spans and counters inside the frame step, and
optional wandb scalar streaming + rich console status (the latter the
port's copy of clid_slam_tpu/utils/observability.py).

Tracing is on exactly while torch's profiler records (``torch.profiler.
profile``, ``emit_nvtx``); no setting turns it on. ``span(name, args)`` is
``record_function(name, args)`` while tracing and a shared no-op context
otherwise, so a span costs one flag check when nothing records. A
top-level span is named ``frame.<stage>`` (or ``ba``) and carries the frame
id as ``args``; a span nested in one is ``frame.<stage>.<part>``.

While tracing, the program counts (``count``): ``frames`` (frames processed
by ``StreamingSlam.process_frame``), ``track.iters`` (IESEKF iterations),
``track.graph_iters`` (those of them that ran as a replay of the cached
tracker's CUDA graph, ``odometry/iekf.py``), ``track.graph_flops`` (those
replays' operations, which the profiler cannot see: a replay dispatches no
torch operation; counted when ``counters()`` is read, by one eager
iteration run then), ``prep.graph_frames`` (tracked frames whose map prep
ran as replays of its CUDA graphs, ``mapping/prep.py:GraphedPrep``),
``map.steps`` (mapping steps, a device scalar on the fused kernel's path,
summed only when ``counters()`` is read) and, on a CUDA device, ``syncs``
with ``syncs.<top-level span>`` and ``syncs.unspanned``: the host's waits on
the card inside ``process_frame``, caught as the warnings of
``torch.cuda.set_sync_debug_mode("warn")`` (error-checked linalg, blocking
copies either way, ``.item()``, ``bool()``, ``int()`` on device values).
Nothing is read from the device inside a frame to count. ``counters()``
returns a snapshot, ``reset_counters()`` clears them; nothing else does, so
the counts of one profiler session run on into the next until a caller
resets them. While syncs are counted, each one also costs the host the
warning that counts it, inside the span being timed.

The wandb and console sinks (``MetricsLogger``) reference the reference's
logging surface (utils/tools.py:161-169 wandb.init, slam.py:379-387
per-frame timing scalars, utils/mapper.py:849-859 per-iteration losses,
utils/slam_dataset.py:759-767 final pose errors; rich console prints
gated by ``silence``, utils/config.py:334).

Both sinks are OPTIONAL and degrade to no-ops: wandb is not bundled in
this image (imported lazily, errors reported once), rich falls back to
plain prints. The logger is host-side only — it consumes the scalars the
pipelines already fetch, never forcing extra device readbacks (on the
streaming path call ``log_frame`` from ``sync()``-side code, not inside
the zero-readback loop).
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Optional

import torch
from torch.profiler import record_function

_NOOP = contextlib.nullcontext()
_SYNC_WARNING = "synchronizing CUDA operation"
_counts: dict = {}
_pending: dict = {}  # name -> device scalar summed on the device, added to _counts when read
_deferred: dict = {}  # name -> functions called when the counters are read
_frame = None  # the _Frame in progress while tracing


def tracing() -> bool:
    """Whether torch's profiler is recording."""
    return torch._C._autograd._profiler_enabled()


def span(name: str, args: Optional[str] = None):
    """A profiler range named ``name`` while tracing, else a no-op."""
    if not tracing():
        return _NOOP
    if _frame is not None and _frame.log is not None and name.count(".") < 2:
        return _SyncSpan(_frame, name, args)
    return record_function(name, args)


def count(name: str, n=1):
    """Add ``n`` to the counter ``name`` while tracing: an int, a device
    scalar read when ``counters()`` is, or a function that returns an int,
    called when ``counters()`` is (for a count whose work would disturb the
    traced frames)."""
    if not tracing():
        return
    if callable(n):
        _deferred.setdefault(name, []).append(n)
    elif isinstance(n, torch.Tensor):
        _pending[name] = _pending[name] + n if name in _pending else n
    else:
        _counts[name] = _counts.get(name, 0) + int(n)


def counters() -> dict:
    """A snapshot of the counters: {name: count}; empty where nothing was
    counted."""
    for name, n in _pending.items():
        _counts[name] = _counts.get(name, 0) + int(n)
    _pending.clear()
    for name, fns in _deferred.items():
        _counts[name] = _counts.get(name, 0) + sum(int(f()) for f in fns)
    _deferred.clear()
    return dict(_counts)


def reset_counters():
    _counts.clear()
    _pending.clear()
    _deferred.clear()


def frame_scope(device: torch.device):
    """The context of one ``process_frame``: while tracing, it counts the
    frame and, on a CUDA device, the host's syncs by top-level span."""
    if not tracing():
        return _NOOP
    return _Frame(device.type == "cuda")


class _Frame:
    def __init__(self, count_syncs: bool):
        self.count_syncs = count_syncs
        self.log = None  # the caught warnings, while counting syncs
        self.others = []  # caught warnings that are not syncs, re-emitted at the end

    def __enter__(self):
        global _frame
        count("frames")
        if self.count_syncs:
            self._catch = warnings.catch_warnings(record=True)
            self.log = self._catch.__enter__()
            warnings.simplefilter("always")
            self._mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        _frame = self
        return self

    def take(self, where: str):
        """Count the syncs caught since the last take as ``where``'s."""
        n = 0
        for w in self.log:
            if _SYNC_WARNING in str(w.message):
                n += 1
            else:
                self.others.append(w)
        self.log.clear()
        if n:
            for name in ("syncs", f"syncs.{where}"):
                _counts[name] = _counts.get(name, 0) + n

    def __exit__(self, *exc):
        global _frame
        _frame = None
        if self.log is None:
            return False
        try:
            torch.cuda.set_sync_debug_mode(self._mode)
            self.take("unspanned")
        finally:
            self._catch.__exit__(*exc)
        for w in self.others:
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno, source=w.source)
        return False


class _SyncSpan:
    """A top-level span while syncs are counted: the syncs caught before it
    are unspanned, those inside it its own."""

    def __init__(self, frame: _Frame, name: str, args: Optional[str]):
        self.frame, self.name = frame, name
        self.range = record_function(name, args)

    def __enter__(self):
        self.frame.take("unspanned")
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        self.frame.take(self.name)
        return False


class MetricsLogger:
    """wandb (optional) + console sink for per-frame and final metrics."""

    def __init__(
        self,
        enabled: bool,
        run_name: str = "clid-slam-tpu",
        run_dir: Optional[str] = None,
        config: Optional[dict] = None,
        silence: bool = True,
        project: str = "CLID_SLAM_TPU",
    ):
        self.silence = silence
        self._wandb = None
        self._console = None
        if not silence:
            try:
                from rich.console import Console

                self._console = Console()
            except ImportError:
                pass
        if enabled:
            try:
                import wandb

                wandb.init(project=project, config=config or {}, dir=run_dir)
                wandb.run.name = run_name
                self._wandb = wandb
            except ImportError:
                self._print(
                    "[observability] wandb_vis_on is set but the optional "
                    "wandb package is not installed; continuing without it"
                )
            except Exception as e:  # offline, auth, ... — never fatal
                self._print(f"[observability] wandb disabled: {e}")

    def _print(self, msg: str):
        if self._console is not None:
            self._console.print(msg)
        elif not self.silence:
            print(msg)

    def log(self, scalars: dict):
        """Stream a dict of scalars (reference wandb_log_content shape)."""
        if self._wandb is not None:
            self._wandb.log(scalars)

    def log_frame(self, frame_id: int, timings: dict, losses: dict):
        """Per-frame timings + losses (slam.py:379-387 semantics)."""
        if self._wandb is not None:
            content = {"frame": frame_id}
            content.update(
                {f"timing(s)/{k}": float(v) for k, v in timings.items()}
            )
            content.update(
                {f"loss/{k}": float(v) for k, v in losses.items()}
            )
            self._wandb.log(content)
        if not self.silence:
            t = sum(float(v) for v in timings.values())
            loss_txt = " ".join(
                f"{k} {float(v):.4f}" for k, v in losses.items()
            )
            self._print(
                f"frame {frame_id}: {t*1e3:.1f} ms  {loss_txt}"
            )

    def log_final(self, metrics: dict):
        """Final pose-error metrics (utils/slam_dataset.py:759-767)."""
        if self._wandb is not None:
            self._wandb.log(
                {
                    f"final/{k}": float(v)
                    for k, v in metrics.items()
                    if isinstance(v, (int, float)) and v == v
                }
            )
        if not self.silence:
            self._print(f"final metrics: {metrics}")

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
