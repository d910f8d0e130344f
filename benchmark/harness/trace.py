"""The traced run's reading: torch.profiler over a steady run of frames,
reduced to what the per-layer readers take.

``attribute_launches`` is a frozen copy of
``chip_smoke.py:launch_attribution`` and ``is_stage`` (lines 2045-2088 as
of commit 806f431), without the per-kernel table: the device time of every
device activity goes to the ``frame.*`` range whose host span holds the
runtime call that launched it (the hand kernels are launched through
ctypes or a C extension, so the profiler ties them to no torch op).

``LaunchRecorder`` records the shapes and indices of every launch of the
hand kernels (K1 ``map_loop``, ``gather_rows``, ``gather_lanes``) while
the profiled frames run, by wrapping the port's wrapper functions wherever
a module of the port holds them; the bytes of each gather are counted
after the profiled frames, so the count adds no work to them.
"""

from __future__ import annotations

import re
import sys
from dataclasses import dataclass, field
from typing import Dict, List

import torch

from . import counts

_K1 = re.compile(r"map_loop")
_GATHER = re.compile(r"(gather_rows|gather_lanes|gather_cols)_(kernel|narrow|staged)")


def is_stage(name: str) -> bool:
    """The profiler ranges of StreamingSlam's stages (``frame.*`` and
    ``ba``) and of the Mesher's launch spans (``mesh.*``)."""
    return name.startswith(("frame.", "mesh.")) or name == "ba"


@dataclass
class Trace:
    """What the readers in ``benchmark/metrics/`` read."""

    frames: int  # frames profiled
    window_s: float  # their wall time, up to the card's idle
    busy_s: float  # time in which some device activity ran
    stage_host_ms: Dict[str, float]  # range -> host ms a frame
    stage_device_ms: Dict[str, float]  # range -> device ms a frame of what it launched
    k1: List[dict]  # per K1 launch: flops, bytes, device_s
    gathers: List[dict]  # per gather launch: kernel, bytes, device_s
    matmul_flops: float  # the profiler's count of the torch matmuls' operations
    peak: dict
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)


class LaunchRecorder:
    def __init__(self):
        self.k1: List[dict] = []
        self.gathers: List[dict] = []
        self._patched = []

    def install(self) -> None:
        from clid_slam_torch.ops import gather as gt
        from clid_slam_torch.ops import map_loop as ml

        rows, lanes, loop = gt.gather_rows, gt.gather_lanes, ml.map_loop
        meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")

        def gather_rows(table, idx):
            out = rows(table, idx)
            if table.is_cuda and idx.shape[0] and table.shape[1]:
                self.gathers.append({"kernel": "gather_rows", "table": meta(table), "idx": idx,
                                     "out": meta(out)})
            return out

        def gather_lanes(src, sel):
            out = lanes(src, sel)
            launched = not (src.requires_grad and torch.is_grad_enabled())
            if src.is_cuda and launched and sel.shape[0] and sel.shape[1]:
                self.gathers.append({"kernel": "gather_lanes", "table": meta(src), "idx": sel,
                                     "out": meta(out)})
            return out

        def map_loop(f0, w0, encw0, label_op, wsel, wtap, enctapw, vd, mlp, n_iters,
                     max_iters, *args, **kw):
            if f0.is_cuda:
                self.k1.append({"bs": f0.shape[0], "K": f0.shape[1], "F": f0.shape[2],
                                "P": encw0.shape[1], "hidden": mlp.w_out.shape[0],
                                "n_hidden": len(mlp.weights), "bd": vd.shape[0],
                                "n_iters": n_iters, "max_iters": max_iters})
            return loop(f0, w0, encw0, label_op, wsel, wtap, enctapw, vd, mlp, n_iters,
                        max_iters, *args, **kw)

        swap = {id(rows): gather_rows, id(lanes): gather_lanes, id(loop): map_loop}
        for name, mod in list(sys.modules.items()):
            if mod is None or name.split(".")[0] != "clid_slam_torch":
                continue
            for attr, value in list(vars(mod).items()):
                if id(value) in swap:
                    setattr(mod, attr, swap[id(value)])
                    self._patched.append((mod, attr, value))

    def uninstall(self) -> None:
        for mod, attr, value in self._patched:
            setattr(mod, attr, value)
        self._patched = []


def attribute_launches(prof, n_profiled: int) -> Dict[str, float]:
    """Device ms per frame of every device activity, by the ``frame.*``
    range whose host span holds the runtime call that launched it, with
    "outside" and "unlinked"."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    ranges = [(e.start_ns(), e.end_ns(), e.name()) for e in events
              if is_stage(e.name()) and e.device_type() != cuda]
    launch_at = {e.correlation_id(): e.start_ns() for e in events if e.device_type() != cuda
                 and any(w in e.name() for w in ("Launch", "Memcpy", "Memset"))}
    by_stage = {}
    for e in events:
        if e.device_type() != cuda or e.is_user_annotation() or is_stage(e.name()):
            continue
        t = launch_at.get(e.correlation_id(), launch_at.get(e.linked_correlation_id()))
        stage = "unlinked" if t is None else next(
            (name for lo, hi, name in ranges if lo <= t <= hi), "outside")
        by_stage[stage] = by_stage.get(stage, 0.0) + e.duration_ns() / 1e6 / n_profiled
    return by_stage


def _union_s(intervals) -> float:
    total, end = 0, None
    for lo, hi in sorted(intervals):
        if end is None or lo > end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total / 1e9


def read_profile(prof, recorder: LaunchRecorder, n_frames: int, window_name: str,
                 device_name: str) -> Trace:
    """The trace of ``n_frames`` frames profiled inside the range
    ``window_name``."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    host = [e for e in events if e.device_type() != cuda]
    win = next(e for e in host if e.name() == window_name)
    w_lo, w_hi = win.start_ns(), win.end_ns()
    stages = [(e.start_ns(), e.end_ns(), e.name()) for e in host if is_stage(e.name())]
    stage_host = {}
    for lo, hi, name in stages:
        stage_host[name] = stage_host.get(name, 0.0) + (hi - lo) / 1e6 / n_frames
    dev = sorted((e for e in events if e.device_type() == cuda and not e.is_user_annotation()
                  and not is_stage(e.name()) and e.name() != window_name),
                 key=lambda e: e.start_ns())
    busy = _union_s((max(e.start_ns(), w_lo), min(e.end_ns(), w_hi)) for e in dev
                    if e.end_ns() > w_lo and e.start_ns() < w_hi)
    peak = counts.peaks(device_name)

    k1_events = [e for e in dev if _K1.search(e.name())]
    k1 = []
    if recorder.k1 and len(k1_events) == len(recorder.k1):
        for rec, e in zip(recorder.k1, k1_events):
            n = min(int(rec["n_iters"]), int(rec["max_iters"]))
            shape = dict(bs=rec["bs"], K=rec["K"], F=rec["F"], P=rec["P"])
            k1.append({"flops": counts.k1_flops(rec["n_hidden"], n, rec["hidden"], rec["bd"],
                                                **shape),
                       "bytes": counts.k1_bytes(rec["n_hidden"], rec["hidden"], rec["bd"],
                                                **shape),
                       "device_s": e.duration_ns() / 1e9})
    elif recorder.k1:
        print(f"# trace: {len(recorder.k1)} K1 calls against {len(k1_events)} K1 kernels: "
              "no K1 roofline", file=sys.stderr)
    g_events = [e for e in dev if _GATHER.search(e.name())]
    gathers = []
    if recorder.gathers and len(g_events) == len(recorder.gathers):
        for rec, e in zip(recorder.gathers, g_events):
            if rec["kernel"] not in e.name():
                gathers = []
                print(f"# trace: gather {rec['kernel']} matched to {e.name()}: no gather "
                      "roofline", file=sys.stderr)
                break
            gathers.append({"kernel": rec["kernel"],
                            "bytes": counts.gather_bytes(rec["kernel"], rec["table"], rec["idx"],
                                                         rec["out"]),
                            "device_s": e.duration_ns() / 1e9})
    elif recorder.gathers:
        print(f"# trace: {len(recorder.gathers)} gather calls against {len(g_events)} gather "
              "kernels: no gather roofline", file=sys.stderr)
    matmul_flops = float(sum(getattr(e, "flops", 0) or 0 for e in prof.key_averages()))

    by_name = {}
    for e in dev:
        by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns() / 1e9
    device_ops = [[n[:120], s] for n, s in sorted(by_name.items(), key=lambda x: -x[1])[:10]]
    gaps, end = [], w_lo
    for e in dev:
        if e.start_ns() > end:
            gaps.append((end, e.start_ns()))
        end = max(end, e.end_ns())
    if w_hi > end:
        gaps.append((end, w_hi))
    named = []
    for lo, hi in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        where = next((n for a, b, n in stages if a <= lo <= b), "outside frame.*")
        named.append([where, (hi - lo) / 1e9])
    return Trace(
        frames=n_frames, window_s=(w_hi - w_lo) / 1e9, busy_s=busy, stage_host_ms=stage_host,
        stage_device_ms=attribute_launches(prof, n_frames), k1=k1, gathers=gathers,
        matmul_flops=matmul_flops, peak=peak, device_ops=device_ops, idle_gaps=named,
    )
