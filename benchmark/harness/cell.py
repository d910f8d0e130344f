"""One run of one cell: set-up, the measured window, the traced frames and
the comparison, as ``benchmark/run.py`` drives them.

Set-up (``setup_s``, from the process's start): the sequence is cast on
the card from the seed (``generator.py``) and handed over as host arrays;
``StreamingSlam`` is built with ``total_frames`` sized to the frames
cast, anchored at the first ground-truth pose and velocity, and
``precompile()``-d; frame 0 and the traffic's warm-up frames run.

The window is a closed loop over the following frames: each frame's time
runs from the call of ``process_frame`` with the frame's host arrays
until its pose is on the host. It closes at the first frame that ends
``seconds`` or more after the first began (and not before the last
sampled frame); a sequence that runs out before then fails the run. Before a sampled frame the whole state of the
system is copied to the host, and after it the frame's outputs; those
copies lie between frames, inside the window's time: into host buffers
allocated during set-up, in the stream's order.

With ``trace``, torch.profiler records ``trace_frames`` frames before
the window (the launch recorder with it), and the per-layer metrics are
read from that record; without it, those frames are the window's first.
Either way the sampled frames lie after them.
"""

from __future__ import annotations

import copy
import gc
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import ate, check, generator, stats, trace as tr

WINDOW_RANGE = "bench.window"


class HostCopy:
    """A host copy of the system's whole state, in buffers allocated
    before it is taken (pinned on the card's host, so that a copy costs the
    window little and waits for nothing: the copy runs in the stream's
    order, before the next frame's work)."""

    def __init__(self, state, pinned: bool):
        self.leaves = [torch.empty(x.shape, dtype=x.dtype, pin_memory=pinned)
                       if isinstance(x, torch.Tensor) else None for x in state.leaves()]
        self.gen = None

    def take(self, state) -> dict:
        for buf, x in zip(self.leaves, state.leaves()):
            if buf is not None:
                buf.copy_(x, non_blocking=True)
        self.gen = state.key.get_state()
        return {"leaves": self.leaves, "gen": self.gen}


def _outputs(system, frame_id: int) -> dict:
    st = system.state
    n = int(st.map_state.count)
    filtered = [int(a) for f, _, a in system.filter_log if f == frame_id]
    return {"count": n, "positions": st.map_state.positions[:n].cpu(),
            "geo_feats": st.map_state.geo_feats[:n].cpu(), "pose": st.odom_poses[frame_id].cpu(),
            "mlp": [t.cpu() for t in st.mlp.tensors()],
            "filtered": filtered[0] if filtered else -1}


def config_doc(cell, seed: int, overrides: dict = None) -> dict:
    """The configuration's file as the system reads it, with the run's
    seed as the configuration's own random seed (the decoders' weights
    and the samplers' draws), and any ``overrides`` ({section: {key:
    value}}, the CPU tests' sizes)."""
    doc = copy.deepcopy({k: v for k, v in cell.config.items() if k != "benchmark"})
    doc.setdefault("setting", {})["random_seed"] = int(seed)
    for sect, kv in (overrides or {}).items():
        doc.setdefault(sect, {}).update(kv)
    return doc


def sample_frames(traffic: dict, seed: int, first: int) -> list:
    """The frames whose outputs the reference works out again: one of the
    warm-up frames (2..warm-up) and ``samples`` of the window's, at
    offsets ``trace_frames`` .. + ``sample_span_frames`` from its first
    frame, drawn from the seed."""
    rng = np.random.default_rng([seed, 1])
    warm = int(traffic["warmup_frames"])
    out = [int(rng.integers(2, warm + 1))] if warm >= 2 else []
    lo = int(traffic["trace_frames"])
    offs = rng.choice(int(traffic["sample_span_frames"]), int(traffic["samples"]), replace=False)
    return out + sorted(first + lo + int(o) for o in offs)


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        overrides: dict = None, n_frames: int = None) -> dict:
    """The run's result: the metrics of its kind, the device record, the
    comparison's numbers with their limits and ``correct``."""
    from clid_slam_torch.config import Config
    from clid_slam_torch.pipeline.streaming import StreamingSlam

    overrides = overrides or {}
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    traffic = dict(cell.traffic, **overrides.get("traffic", {}))
    sensor = dict(cell.config["benchmark"]["sensor"], **overrides.get("sensor", {}))
    doc = config_doc(cell, seed, overrides.get("config"))
    cfg = Config.from_dict(doc)
    n_frames = int(traffic["frames"] if n_frames is None else n_frames)
    t_gen = time.perf_counter()
    seq = generator.generate(sensor, traffic, cfg.T_imu_lidar, seed, dev, n_frames)
    marks = {"imports": t_gen - t_start, "cast": time.perf_counter() - t_gen}
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        # the generator's scratch is the benchmark's, not the system's
        torch.cuda.reset_peak_memory_stats(dev)

    system = StreamingSlam(cfg, total_frames=n_frames, device=dev)
    system.seed_pose(seq.poses[0][:3, :3], seq.poses[0][:3, 3], seq.velocity0)
    t = time.perf_counter()
    system.precompile()
    marks["precompile"] = time.perf_counter() - t

    def frame(i):
        system.process_frame(i, seq.scans[i], seq.imu[i], point_ts=seq.point_ts[i])
        return system.state.odom_poses[i].cpu()  # the frame ends with its pose on the host

    warm = int(traffic["warmup_frames"])
    first = warm + 1
    picks = sample_frames(traffic, seed, first)
    before, samples = {}, []
    t = time.perf_counter()
    copies = [HostCopy(system.state, on_card) for _ in range(len(picks) + 1)]
    marks["host buffers"] = time.perf_counter() - t
    if trace and on_card:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device=dev).add_(1)  # the profiler's own first-use cost
    t = time.perf_counter()
    frame(0)
    marks["frame0"] = time.perf_counter() - t
    start = copies.pop().take(system.state)
    t = time.perf_counter()
    for i in range(1, first):
        if i in picks:
            before[i] = copies.pop().take(system.state)
        frame(i)
        if i in picks:
            samples.append((i, before.pop(i), _outputs(system, i)))
    system.block()
    marks["warm-up"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    print(f"# set-up {setup_s:.3f} s ({', '.join(f'{k} {v:.3f}' for k, v in marks.items())}; "
          f"frames cast: {n_frames}, points a frame: {np.mean([len(s) for s in seq.scans]):.0f}; "
          f"sampled: {picks})", file=sys.stderr)

    n_trace = int(traffic["trace_frames"]) if trace else 0
    prof = recorder = None
    latencies = []
    i = first
    t0 = time.perf_counter()
    while True:
        if i >= n_frames:
            raise RuntimeError(f"the sequence ran out at frame {i}: the window needs more "
                               "frames than the traffic casts")
        if n_trace and i == first:
            recorder = tr.LaunchRecorder()
            recorder.install()
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                           with_flops=True, acc_events=True)
            prof.__enter__()
            win = record_function(WINDOW_RANGE)
            win.__enter__()
        if i in picks:
            before[i] = copies.pop().take(system.state)
        tc = time.perf_counter()
        frame(i)
        td = time.perf_counter()
        latencies.append(td - tc)
        if i in picks:
            samples.append((i, before.pop(i), _outputs(system, i)))
        i += 1
        if n_trace and i == first + n_trace:
            system.block()
            win.__exit__(None, None, None)
            t = time.perf_counter()
            prof.__exit__(None, None, None)
            recorder.uninstall()
            print(f"# traced frames: {(t - t0) * 1e3:.1f} ms, the profiler's close "
                  f"{(time.perf_counter() - t) * 1e3:.1f} ms", file=sys.stderr)
            # the measured window starts after the traced frames
            latencies = []
            t0 = time.perf_counter()
        if td - t0 >= seconds and i > max(picks[-1], first + n_trace - 1):
            break
    window_s = td - t0
    n_done = len(latencies)

    mem_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    out = system.sync()
    system.block()  # the host copies are complete
    est = out["odom_poses"][first:i]
    failed = int(np.sum(~np.all(np.isfinite(est), axis=(1, 2))))
    halves = (stats.frames_per_s(n_done // 2, float(np.sum(latencies[: n_done // 2]))),
              stats.frames_per_s(n_done - n_done // 2, float(np.sum(latencies[n_done // 2:]))))
    err = ate.absolute_error(out["odom_poses"][:i], seq.poses[:i], align=False)
    lat_ms = np.asarray(latencies) * 1e3
    print(f"# frame ms: median {np.median(lat_ms):.2f}, p95 {np.percentile(lat_ms, 95):.2f}, "
          f"max {lat_ms.max():.2f}; the window's wall outside frames "
          f"{(window_s - np.sum(latencies)) * 1e3:.1f} ms", file=sys.stderr)
    print(f"# window: {n_done} frames in {window_s:.3f} s; rate by halves "
          f"{halves[0]:.3f} / {halves[1]:.3f} frames/s; over frames 0-{i - 1} ATE rmse "
          f"{err['ate_rmse_m']:.4f} m, ARE rmse {err['are_rmse_deg']:.4f} deg (not aligned); "
          f"neural points {out['neural_points']}", file=sys.stderr)

    traced = None
    if n_trace:
        name = torch.cuda.get_device_name(dev) if on_card else "cpu"
        traced = tr.read_profile(prof, recorder, n_trace, WINDOW_RANGE, name)
        prof = recorder = None

    del system, out
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = check.compare(doc, seq, n_frames, start, samples, seed, cell.limits["probe"], dev)
    limits = {k: v for k, v in cell.limits.items() if isinstance(v, dict) and "limit" in v}
    correct, rows = check.judge(numbers, limits)

    res = {"attempted": n_done, "failed": failed, "correct": correct and failed == 0,
           "checks": rows, "setup_s": setup_s, "window_s": window_s, "frames": n_done,
           "latencies": latencies, "mem_peak": mem_peak, "trace": traced}
    return res
